// Real-space Ewald pair sums on the host, for the port's EwaldSummation
// (smol_tpu_torch/crystal/ewald.py).
//
// The port's copy of ewald_real_sums in native/smol_host.cpp: the same loops,
// the same order of summation and the same skipped coincident pairs.  Built
// with g++ into a plain C library (smol_tpu_torch/ops/_build.py,
// load_host_ewald) and loaded with ctypes; there is no numpy fallback.
//
// The reference's library is built with -march=native under GCC's default
// -ffp-contract=fast, so on a CPU with FMA its r2 = dx*dx + dy*dy + dz*dz
// becomes fma(dz, dz, fma(dx, dx, dy * dy)); the committed Ewald matrices
// hold those bits.  Here the two fused multiply-adds are written out and
// the library is built with -ffp-contract=off (HOST_FLAGS in _build.py), so
// the sums do not depend on whether the CPU has FMA or how the compiler
// contracts: std::fma rounds once with or without the instruction.  Only
// std::erfc comes from the host's C library.

#include <cmath>
#include <cstdint>

extern "C" {

// For sites i, j (cartesian coords [n, 3]) and periodic images `img_cart`
// [m, 3], accumulate
//   out[i, j] = sum_images erfc(sqrt_eta * r) / r   for 0 < r <= rmax
// in image order, excluding the zero-distance self term.  Symmetric [n, n].
void smol_host_ewald_real_sums(const double* coords, int64_t n,
                               const double* img_cart, int64_t m,
                               double sqrt_eta, double rmax, double* out) {
    const double rmax2 = rmax * rmax;
#pragma omp parallel for schedule(dynamic, 4)
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = i; j < n; ++j) {
            const double bx = coords[3 * i + 0] - coords[3 * j + 0];
            const double by = coords[3 * i + 1] - coords[3 * j + 1];
            const double bz = coords[3 * i + 2] - coords[3 * j + 2];
            double acc = 0.0;
            for (int64_t k = 0; k < m; ++k) {
                const double dx = bx - img_cart[3 * k + 0];
                const double dy = by - img_cart[3 * k + 1];
                const double dz = bz - img_cart[3 * k + 2];
                const double r2 = std::fma(dz, dz, std::fma(dx, dx, dy * dy));
                if (r2 > rmax2 || r2 < 1e-24) continue;
                const double r = std::sqrt(r2);
                acc += std::erfc(sqrt_eta * r) / r;
            }
            out[i * n + j] = acc;
            out[j * n + i] = acc;
        }
    }
}

}  // extern "C"

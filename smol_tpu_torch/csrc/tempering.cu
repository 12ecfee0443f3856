// Replica-exchange sweep of parallel tempering for NVIDIA Hopper (sm_90a).
//
// The exchange step of smol_tpu/parallel/tempering.py `tempering_exchange`
// (:42).  In the reference it is a handful of jnp operations that XLA fuses
// between two launches of the Pallas chain; it is not a Pallas kernel.  On
// the GPU the same operations in torch are about eight launches, and an
// exchange follows every segment of `period` chain steps (10 on bench
// `tempering`, tens of microseconds of chain kernel), so they would cost
// the host more than the segment costs the card.  This kernel is the whole
// sweep in one launch.
//
// One thread per pair (l, l + 1) with l = 2 p + phase and l + 1 < W (no
// wrapping pair).  The decision is made at the left member and shared with
// its partner, as the reference does: with d = (beta_l - beta_r) (H_l - H_r)
// in f64, the pair exchanges its temperatures if d >= 0 or d > log u_l, u
// the walker's uniform in [0, 1).  An exchange swaps beta_l and beta_r
// (f64) and the f32 copies beta32 that the flip and swap chains read, so
// the next segment needs no conversion launch, and, where a count is
// given, adds one to the left member's accepted exchanges.  The plain
// torch twin is `tempering_exchange` in
// smol_tpu_torch/parallel/tempering.py; both take the product of two
// differences (no fused multiply-add can form) and the f64 log, so they
// make the same decisions bit for bit.
//
// What bounds it: its launch; W / 2 threads read 3 f64 per walker and write
// at most 16 bytes per walker, under a microsecond of bandwidth at 8192
// walkers.  The C entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
exchange_kernel(double* __restrict__ beta, float* __restrict__ beta32,
                const double* __restrict__ enthalpy,
                const double* __restrict__ uniforms,
                int32_t* __restrict__ accepted, int W, int phase) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = 2 * p + phase;
  const int r = l + 1;
  if (r >= W) return;
  const double bl = beta[l];
  const double br = beta[r];
  const double d = (bl - br) * (enthalpy[l] - enthalpy[r]);
  if (d >= 0.0 || d > log(uniforms[l])) {
    beta[l] = br;
    beta[r] = bl;
    beta32[l] = (float)br;
    beta32[r] = (float)bl;
    if (accepted != nullptr) accepted[l] += 1;
  }
}

}  // namespace

extern "C" int smol_tempering(void* beta, void* beta32, const void* enthalpy,
                              const void* uniforms, void* accepted, int W,
                              int phase, void* stream) {
  const int pairs = W / 2;  // the most pairs of either phase
  if (pairs == 0) return (int)cudaSuccess;
  const int blocks = (pairs + kThreads - 1) / kThreads;
  exchange_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (double*)beta, (float*)beta32, (const double*)enthalpy,
      (const double*)uniforms, (int32_t*)accepted, W, phase & 1);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

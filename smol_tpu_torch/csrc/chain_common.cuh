// Pieces shared by the chain kernels flip_chain.cu, swap_chain.cu,
// table_chain.cu, wl_chain.cu and distance_chain.cu.
//
// - the random bits: the reference's interpret-mode hash, bit for bit, and
//   Philox4x32-10 (replacing the TPU hardware PRNG of smol_tpu/ops/prims.py);
// - one rank's table rows in shared memory and their cp.async prefetch
//   (the analog of the reference's streamed-table DMA, pallas_chain.py
//   :1590-1626);
// - the cluster-expansion delta of one site (direct f64 lookups, summed in
//   the order l = 0, 1, ...);
// - K4, the Ewald term sign * (C_r + V_r . occ) of pallas_chain.py
//   `ewald_delta` (:1651), in f64 over the block's codes in rank order;
// - the whole delta of a flip and of a swap (flip_delta, swap_delta), which
//   the Metropolis chains and the Wang-Landau chain both call.
//
// The plain torch twins in ops/chain.py sum in the same orders, so kernel
// and twin give the same f64 deltas.  Build without fast-math: nothing may
// reorder these sums.

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace smol {

constexpr int kMaxThreads = 64;
constexpr int kRngPhilox = 0;
constexpr int kRngHash = 1;

__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t step,
                                              uint32_t slot, uint32_t lane) {
  // murmur3-finalizer hash of smol_tpu/ops/pallas_chain.py _hash_uniform01
  // (int32 wrapping products and logical shifts == uint32 arithmetic)
  uint32_t x = lane + seed * (2654435761u & 0x7FFFFFFFu);
  x ^= step * 40503u + slot * (2246822519u & 0x7FFFFFFFu);
  x ^= x >> 13;
  x *= 0x85EBCA6Bu;                            // -2048144789 as uint32
  x ^= x >> 16;
  x *= 0xC2B2AE35u;                            // -1028477387 as uint32
  x ^= x >> 16;
  return x & 0x7FFFFFFFu;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The random bits of one walker's chain launch.
struct Draws {
  uint32_t block_seed;  // hash mode: seed_chunk + group * 7919 (int32 wrap)
  uint32_t lane;        // hash mode: walker index within its group
  uint2 key;            // philox: (seed low word, walker)
  uint32_t seed_hi;     // philox: counter word 1

  __device__ Draws(int64_t seed, int grp, int wc, int block_size)
      : block_seed((uint32_t)seed + (uint32_t)grp * 7919u),
        lane((uint32_t)(wc % block_size)),
        key(make_uint2((uint32_t)((uint64_t)seed & 0xFFFFFFFFu), (uint32_t)wc)),
        seed_hi((uint32_t)((uint64_t)seed >> 32)) {}

  // (r_u, r_j) of step i: the acceptance bits and the proposed-code bits
  __device__ __forceinline__ uint2 at(int i, int rng_mode) const {
    if (rng_mode == kRngHash) {
      return make_uint2(hash_bits(block_seed, (uint32_t)i, 1u, lane),
                        hash_bits(block_seed, (uint32_t)i, 0u, lane));
    }
    const uint4 x = philox4x32_10(make_uint4((uint32_t)i, seed_hi, 0u, 0u), key);
    return make_uint2(x.x & 0x7FFFFFFFu, x.y & 0x7FFFFFFFu);
  }
};

// Accept on an f32 exponent: expo >= 0 or expo > log U, with U in (0, 1]
// from the 31 random bits r_u, as the reference takes it (:1879, :1883).
__device__ __forceinline__ bool accept_exponent(float expo, uint32_t r_u) {
  const float unif = ((float)(r_u >> 7) + 1.0f) * 5.9604644775390625e-8f;
  return expo >= 0.0f || expo > logf(unif);
}

// The Metropolis decision in f32, as the reference takes it (:1882).
__device__ __forceinline__ bool metropolis(float beta, double dE, uint32_t r_u) {
  return accept_exponent(-beta * (float)dE, r_u);
}

struct Rows {  // one rank's table rows in shared memory
  double* g;      // [L, TM]
  double* ew;     // [RE] Ewald row V_r (RE = R with an Ewald term, else 0)
  int32_t* nbr;   // [L, K]
  int32_t* st;    // [L, K]
  int32_t* d2;    // [L]
};

__host__ __device__ __forceinline__ size_t rows_bytes(int L, int K, int TM,
                                                      int RE) {
  const size_t bytes =
      (size_t)L * TM * 8 + (size_t)RE * 8 + (size_t)L * (2 * K + 1) * 4;
  return (bytes + 15) / 16 * 16;  // keeps the next buffer's g aligned
}

__device__ __forceinline__ Rows rows_at(unsigned char* base, int L, int K,
                                        int TM, int RE) {
  Rows r;
  r.g = reinterpret_cast<double*>(base);
  r.ew = r.g + (size_t)L * TM;
  r.nbr = reinterpret_cast<int32_t*>(r.ew + RE);
  r.st = r.nbr + L * K;
  r.d2 = r.st + L * K;
  return r;
}

// Issue the asynchronous copy of rank u's rows into `dst` (all threads).
__device__ __forceinline__ void copy_rows(const Rows& dst, int u,
                                          const int32_t* __restrict__ nbr,
                                          const int32_t* __restrict__ stride,
                                          const int32_t* __restrict__ d2,
                                          const double* __restrict__ g,
                                          const double* __restrict__ ew_v,
                                          int L, int K, int TM, int RE,
                                          int tid, int nt) {
  const double* g_u = g + (size_t)u * L * TM;
  for (int x = tid; x < L * TM; x += nt) {
    __pipeline_memcpy_async(dst.g + x, g_u + x, sizeof(double));
  }
  const double* ew_u = ew_v + (size_t)u * RE;
  for (int x = tid; x < RE; x += nt) {
    __pipeline_memcpy_async(dst.ew + x, ew_u + x, sizeof(double));
  }
  const int32_t* nb_u = nbr + (size_t)u * L * K;
  const int32_t* st_u = stride + (size_t)u * L * K;
  for (int x = tid; x < L * K; x += nt) {
    __pipeline_memcpy_async(dst.nbr + x, nb_u + x, sizeof(int32_t));
    __pipeline_memcpy_async(dst.st + x, st_u + x, sizeof(int32_t));
  }
  const int32_t* d2_u = d2 + (size_t)u * L;
  for (int x = tid; x < L; x += nt) {
    __pipeline_memcpy_async(dst.d2 + x, d2_u + x, sizeof(int32_t));
  }
  __pipeline_commit();
}

// dE plus the cluster-expansion change of the rank whose rows are `rows`
// going from code a to b, one term per local cluster in order l = 0, 1, ...:
// t = d2 * a + sum_k stride * code(nbr), term = g[l, t + d2 (b - a)] - g[l, t].
// KT > 0: the slot count K as a compile-time constant; KT == 0: runtime K.
// On an H100 a runtime K ran 2.8x slower per step than the constant on the
// spinel (K = 3), so K = 3 has its own instantiations.
template <int KT>
__device__ __forceinline__ double ce_add(double dE, const Rows& rows,
                                         const int8_t* s_occ, int nt, int tid,
                                         int L, int K_rt, int TM, int a,
                                         int b) {
  const int K = KT > 0 ? KT : K_rt;
#pragma unroll 8
  for (int l = 0; l < L; ++l) {
    const int d = rows.d2[l];
    int t = d * a;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int n = rows.nbr[l * K + k];
      const int code = n >= 0 ? (int)s_occ[n * nt + tid] : 0;
      t += rows.st[l * K + k] * code;
    }
    const int tn = t + d * (b - a);
    const double term = rows.g[l * TM + tn] - rows.g[l * TM + t];
    dE += term;
  }
  return dE;
}

// K4: sign * (C_r + V_r . occ) with the dot over the walker's codes in rank
// order t = 0 .. R-1.  Ewald systems have 0/1 codes, so every product is
// exact and the sum rounds as the twin's rank-order loop does.
__device__ __forceinline__ double ewald_term(const double* row, double c,
                                             const int8_t* s_occ, int nt,
                                             int tid, int R, int sign) {
  double acc = 0.0;
#pragma unroll 8
  for (int t = 0; t < R; ++t) {
    acc += row[t] * (double)s_occ[t * nt + tid];
  }
  return (double)sign * (c + acc);
}

// A flip's delta: rank u (rows `rows`) going from code a to b.  Cluster
// terms, then the Ewald term, then minus the chemical work mu[u, b] -
// mu[u, a] (mu is [R, C]).
template <int KT, bool EW>
__device__ __forceinline__ double flip_delta(const Rows& rows, int u, int a,
                                             int b, const int8_t* s_occ,
                                             int nt, int tid, int R, int L,
                                             int K, int TM, int C,
                                             const double* __restrict__ mu,
                                             const double* __restrict__ ew_c) {
  double dE = ce_add<KT>(0.0, rows, s_occ, nt, tid, L, K, TM, a, b);
  if (EW) {
    dE += ewald_term(rows.ew, __ldg(ew_c + u), s_occ, nt, tid, R, b - a);
  }
  const double work = __ldg(mu + u * C + b) - __ldg(mu + u * C + a);
  dE -= work;
  return dE;
}

// A swap's joint delta: rank u (rows ru, cell cu) going a -> b, then rank v
// (rows rv) going b -> a against the occupancy with u already holding b,
// then u's Ewald term (taken before u is recolored), then v's.  Leaves b in
// u's cell: on accept the caller writes a into v's cell, on reject a back
// into u's.
template <int KT, bool EW>
__device__ __forceinline__ double swap_delta(const Rows& ru, const Rows& rv,
                                             int u, int v, int8_t* cu, int a,
                                             int b, const int8_t* s_occ,
                                             int nt, int tid, int R, int L,
                                             int K, int TM,
                                             const double* __restrict__ ew_c) {
  double ewald_u = 0.0;
  if (EW) ewald_u = ewald_term(ru.ew, __ldg(ew_c + u), s_occ, nt, tid, R, b - a);
  double dE = ce_add<KT>(0.0, ru, s_occ, nt, tid, L, K, TM, a, b);
  *cu = (int8_t)b;  // v's delta sees u already holding b
  dE = ce_add<KT>(dE, rv, s_occ, nt, tid, L, K, TM, b, a);
  if (EW) {
    dE += ewald_u;
    dE += ewald_term(rv.ew, __ldg(ew_c + v), s_occ, nt, tid, R, a - b);
  }
  return dE;
}

inline int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Threads of a CUDA block: a block must lie inside one sequence group of
// block_size walkers, since its threads share the group's proposals.
inline int block_threads(int W, int block_size) {
  return (W <= block_size || block_size % kMaxThreads == 0)
             ? kMaxThreads
             : gcd(block_size, kMaxThreads);
}

// Raise the dynamic shared-memory limit where the kernel needs above 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace smol

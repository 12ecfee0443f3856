// Shared-proposal single-flip Metropolis chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU chain kernel of smol_tpu/ops/pallas_chain.py
// (make_shared_proposal_chain, move="flip": `kernel` and `step`), with its
// site delta (make_site_delta / make_site_delta_ising), chemical work
// (mu_work) and Metropolis accept, and the TPU's hardware PRNG
// (smol_tpu/ops/prims.py).  What differs from the TPU design:
//
// - One thread per walker.  Walkers w with the same w / block_size share a
//   row of the exogenous site sequence (the statistical contract of the
//   reference); block_size is the statistical block, independent of the
//   CUDA block size, which divides it so that a CUDA block shares one
//   sequence row.  The steps of a whole window run in a loop inside the
//   kernel.
// - The energy delta is one direct table load per local cluster:
//   t = d2 * a + sum_k stride * code(nbr), dE = sum_l g[l, t_new] - g[l, t_old],
//   summed in native f64 in the order l = 0, 1, ... (the reference needs
//   double-float pairs and select loops because a TPU has no f64 vector
//   unit and slow gathers).  The plain torch twin in ops/chain.py sums in
//   the same order, so both give the same f64 delta.
// - The acceptance exponent is taken in f32, as the reference does, so
//   trajectories can be compared with it; the enthalpy accumulates in f64.
// - Random numbers: Philox4x32-10 keyed by (seed, walker) with the step as
//   counter in run mode, or the reference's interpret-mode hash of
//   (seed, step, slot, lane) bit for bit in hash mode.
//
// What bounds it on this card: the steps of one walker form a dependent
// chain (each decision needs the previous occupancy), so a step costs the
// latency of its table lookups, not bandwidth, and a few thousand walkers
// give only about two warps per SM to hide it.  The design keeps every
// lookup on chip: the walkers' codes live in shared memory for the whole
// window, and the proposal rank's table rows (nbr, stride, d2, g; a few KB)
// are copied into shared memory one step ahead with cp.async, double
// buffered, since the site sequence is known in advance (the analog of the
// reference's streamed-table prefetch).  Read straight from L2 instead,
// the rows cost two dependent L2 round trips per local cluster.
//
// The occupancy ([R, W] int8 codes, rank-major), enthalpy and accept
// counts are updated in place.  The C entry point returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

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

struct Rows {  // one rank's table rows in shared memory
  double* g;      // [L, TM]
  int32_t* nbr;   // [L, K]
  int32_t* st;    // [L, K]
  int32_t* d2;    // [L]
};

// Shared memory: two Rows buffers, then the block's codes [R, nt] int8.
__host__ __device__ __forceinline__ size_t rows_bytes(int L, int K, int TM) {
  const size_t bytes = (size_t)L * TM * 8 + (size_t)L * (2 * K + 1) * 4;
  return (bytes + 15) / 16 * 16;  // keeps the second buffer's g aligned
}

__device__ __forceinline__ Rows rows_at(unsigned char* base, int L, int K,
                                        int TM) {
  Rows r;
  r.g = reinterpret_cast<double*>(base);
  r.nbr = reinterpret_cast<int32_t*>(base + (size_t)L * TM * 8);
  r.st = r.nbr + L * K;
  r.d2 = r.st + L * K;
  return r;
}

// Issue the asynchronous copy of rank u's rows into `dst` (all threads).
__device__ __forceinline__ void copy_rows(const Rows& dst, int u,
                                          const int32_t* __restrict__ nbr,
                                          const int32_t* __restrict__ stride,
                                          const int32_t* __restrict__ d2,
                                          const double* __restrict__ g, int L,
                                          int K, int TM, int tid, int nt) {
  const double* g_u = g + (size_t)u * L * TM;
  for (int x = tid; x < L * TM; x += nt) {
    __pipeline_memcpy_async(dst.g + x, g_u + x, sizeof(double));
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

// KT > 0: the slot count K as a compile-time constant; KT == 0: runtime K.
// On an H100 a runtime K ran 2.8x slower per step than the constant on the
// spinel (K = 3), so the spinel's K = 3 has its own instantiation.
template <int KT>
__global__ void __launch_bounds__(kMaxThreads)
flip_chain_kernel(int8_t* __restrict__ occ, double* __restrict__ enthalpy,
                  int32_t* __restrict__ naccept,
                  const float* __restrict__ beta,
                  const int32_t* __restrict__ seq, int seq_stride,
                  const int64_t* __restrict__ seed_ptr,
                  const int32_t* __restrict__ nbr,
                  const int32_t* __restrict__ stride,
                  const int32_t* __restrict__ d2,
                  const double* __restrict__ g,
                  const double* __restrict__ mu,
                  const int32_t* __restrict__ ncode, int R, int L, int K_rt,
                  int TM, int C, int W, int block_size, int n_steps,
                  int rng_mode) {
  const int K = KT > 0 ? KT : K_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = rows_bytes(L, K, TM);
  int8_t* s_occ = reinterpret_cast<int8_t*>(smem + 2 * rb);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int w = blockIdx.x * nt + tid;
  const bool live = w < W;
  const int wc = live ? w : W - 1;  // dead threads shadow the last walker

  for (int r = 0; r < R; ++r) {
    s_occ[r * nt + tid] = occ[(size_t)r * W + wc];
  }
  double e = enthalpy[wc];
  const float b32 = beta[wc];
  int nacc = 0;

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = (blockIdx.x * nt) / block_size;
  const uint32_t lane = (uint32_t)(wc % block_size);
  const int32_t* my_seq = seq + (size_t)grp * seq_stride;
  const int64_t seed = *seed_ptr;
  // hash mode: block_seed = seed_chunk + block * 7919 (int32 wrap)
  const uint32_t block_seed = (uint32_t)seed + (uint32_t)grp * 7919u;
  const uint2 key = make_uint2((uint32_t)((uint64_t)seed & 0xFFFFFFFFu),
                               (uint32_t)wc);
  const uint32_t seed_hi = (uint32_t)((uint64_t)seed >> 32);

  if (n_steps > 0) {
    copy_rows(rows_at(smem, L, K, TM), __ldg(my_seq), nbr, stride, d2, g, L,
              K, TM, tid, nt);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    const Rows rows = rows_at(smem + (i & 1) * rb, L, K, TM);
    if (i + 1 < n_steps) {  // prefetch the next step's rows
      copy_rows(rows_at(smem + ((i + 1) & 1) * rb, L, K, TM),
                __ldg(my_seq + i + 1), nbr, stride, d2, g, L, K, TM, tid, nt);
    }
    const int u = __ldg(my_seq + i);
    int8_t* cell = s_occ + u * nt + tid;
    const int a = *cell;

    uint32_t r_u, r_j;
    if (rng_mode == kRngHash) {
      r_j = hash_bits(block_seed, (uint32_t)i, 0u, lane);
      r_u = hash_bits(block_seed, (uint32_t)i, 1u, lane);
    } else {
      const uint4 x = philox4x32_10(make_uint4((uint32_t)i, seed_hi, 0u, 0u), key);
      r_u = x.x & 0x7FFFFFFFu;
      r_j = x.y & 0x7FFFFFFFu;
    }
    const int nc = max(__ldg(ncode + u) - 1, 1);
    const int j = (int)(r_j % (uint32_t)nc);
    const int b = j + (j >= a ? 1 : 0);

    double dE = 0.0;
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
    const double work = __ldg(mu + u * C + b) - __ldg(mu + u * C + a);
    dE -= work;

    const float unif = ((float)(r_u >> 7) + 1.0f) * 5.9604644775390625e-8f;
    const float expo = -b32 * (float)dE;
    const bool accept = expo >= 0.0f || expo > logf(unif);
    if (accept) {
      *cell = (int8_t)b;
      e += dE;
      ++nacc;
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  if (live) {
    for (int r = 0; r < R; ++r) {
      occ[(size_t)r * W + w] = s_occ[r * nt + tid];
    }
    enthalpy[w] = e;
    naccept[w] += nacc;
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

}  // namespace

extern "C" int smol_flip_chain(void* occ, void* enthalpy, void* naccept,
                               const void* beta, const void* seq,
                               int seq_stride, const void* seed,
                               const void* nbr, const void* stride,
                               const void* d2, const void* g, const void* mu,
                               const void* ncode, int R, int L, int K, int TM,
                               int C, int W, int block_size, int n_steps,
                               int rng_mode, void* stream) {
  // a CUDA block must lie inside one sequence group of block_size walkers
  const int threads = (W <= block_size || block_size % kMaxThreads == 0)
                          ? kMaxThreads
                          : gcd(block_size, kMaxThreads);
  const size_t smem = 2 * rows_bytes(L, K, TM) + (size_t)R * threads;
  auto kernel = K == 3 ? flip_chain_kernel<3> : flip_chain_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (W + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (int8_t*)occ, (double*)enthalpy, (int32_t*)naccept, (const float*)beta,
      (const int32_t*)seq, seq_stride, (const int64_t*)seed,
      (const int32_t*)nbr, (const int32_t*)stride, (const int32_t*)d2,
      (const double*)g, (const double*)mu, (const int32_t*)ncode, R, L, K, TM,
      C, W, block_size, n_steps, rng_mode);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

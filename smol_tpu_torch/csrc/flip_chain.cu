// Shared-proposal single-flip Metropolis chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU chain kernel of smol_tpu/ops/pallas_chain.py
// (make_shared_proposal_chain, move="flip": `kernel` and `step`), with its
// site delta (make_site_delta / make_site_delta_ising), Ewald term
// (ewald_delta, K4), chemical work (mu_work) and Metropolis accept, and the
// TPU's hardware PRNG (smol_tpu/ops/prims.py).  What differs from the TPU
// design:
//
// - One thread per walker.  Walkers w with the same w / block_size share a
//   row of the exogenous site sequence (the statistical contract of the
//   reference); block_size is the statistical block, independent of the
//   CUDA block size, which divides it so that a CUDA block shares one
//   sequence row.  The steps of a whole window run in a loop inside the
//   kernel.
// - The energy delta is one direct table load per local cluster:
//   t = d2 * a + sum_k stride * code(nbr), dE = sum_l g[l, t_new] - g[l, t_old],
//   summed in native f64 in the order l = 0, 1, ..., then the Ewald term
//   (b - a) * (C_u + V_u . occ) in f64, then the chemical work (the
//   reference needs double-float pairs and select loops because a TPU has
//   no f64 vector unit and slow gathers, and takes the Ewald dot in f32).
//   The plain torch twin in ops/chain.py sums in the same order, so both
//   give the same f64 delta.
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
// window, and the proposal rank's table rows (nbr, stride, d2, g and the
// Ewald row; a few KB) are copied into shared memory one step ahead with
// cp.async, double buffered, since the site sequence is known in advance
// (the analog of the reference's streamed-table prefetch).  Read straight
// from L2 instead, the rows cost two dependent L2 round trips per local
// cluster.
//
// The occupancy ([R, W] int8 codes, rank-major), enthalpy and accept
// counts are updated in place.  The C entry point returns
// cudaGetLastError() after the launch.

#include "chain_common.cuh"

namespace {

using namespace smol;

// KT: the slot count K as a compile-time constant (0: runtime K);
// EW: the tables carry the Ewald fold (ew_v [R, R], ew_c [R]).
template <int KT, bool EW>
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
                  const int32_t* __restrict__ ncode,
                  const double* __restrict__ ew_v,
                  const double* __restrict__ ew_c, int R, int L, int K_rt,
                  int TM, int C, int W, int block_size, int n_steps,
                  int rng_mode) {
  const int K = KT > 0 ? KT : K_rt;
  const int RE = EW ? R : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = rows_bytes(L, K, TM, RE);
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
  const int32_t* my_seq = seq + (size_t)grp * seq_stride;
  const Draws draws(*seed_ptr, grp, wc, block_size);

  if (n_steps > 0) {
    copy_rows(rows_at(smem, L, K, TM, RE), __ldg(my_seq), nbr, stride, d2, g,
              ew_v, L, K, TM, RE, tid, nt);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    const Rows rows = rows_at(smem + (i & 1) * rb, L, K, TM, RE);
    if (i + 1 < n_steps) {  // prefetch the next step's rows
      copy_rows(rows_at(smem + ((i + 1) & 1) * rb, L, K, TM, RE),
                __ldg(my_seq + i + 1), nbr, stride, d2, g, ew_v, L, K, TM, RE,
                tid, nt);
    }
    const int u = __ldg(my_seq + i);
    int8_t* cell = s_occ + u * nt + tid;
    const int a = *cell;

    const uint2 bits = draws.at(i, rng_mode);  // (r_u, r_j)
    const int nc = max(__ldg(ncode + u) - 1, 1);
    const int j = (int)(bits.y % (uint32_t)nc);
    const int b = j + (j >= a ? 1 : 0);

    const double dE = flip_delta<KT, EW>(rows, u, a, b, s_occ, nt, tid, R, L, K,
                                         TM, C, mu, ew_c);

    if (metropolis(b32, dE, bits.x)) {
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

}  // namespace

extern "C" int smol_flip_chain(void* occ, void* enthalpy, void* naccept,
                               const void* beta, const void* seq,
                               int seq_stride, const void* seed,
                               const void* nbr, const void* stride,
                               const void* d2, const void* g, const void* mu,
                               const void* ncode, const void* ew_v,
                               const void* ew_c, int R, int L, int K, int TM,
                               int C, int W, int block_size, int n_steps,
                               int rng_mode, void* stream) {
  const int threads = block_threads(W, block_size);
  const bool ew = ew_v != nullptr;
  const size_t smem = 2 * rows_bytes(L, K, TM, ew ? R : 0) + (size_t)R * threads;
  auto kernel = ew ? (K == 3 ? flip_chain_kernel<3, true> : flip_chain_kernel<0, true>)
                   : (K == 3 ? flip_chain_kernel<3, false> : flip_chain_kernel<0, false>);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (W + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (int8_t*)occ, (double*)enthalpy, (int32_t*)naccept, (const float*)beta,
      (const int32_t*)seq, seq_stride, (const int64_t*)seed,
      (const int32_t*)nbr, (const int32_t*)stride, (const int32_t*)d2,
      (const double*)g, (const double*)mu, (const int32_t*)ncode,
      (const double*)ew_v, (const double*)ew_c, R, L, K, TM, C, W, block_size,
      n_steps, rng_mode);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

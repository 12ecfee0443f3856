// Shared-proposal single-flip Metropolis chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU chain kernel of smol_tpu/ops/pallas_chain.py
// (make_shared_proposal_chain, move="flip": `kernel` and `step`), with its
// site delta (make_site_delta / make_site_delta_ising /
// make_site_delta_qary), Ewald term (ewald_delta, K4), chemical work
// (mu_work) and Metropolis accept, and the TPU's hardware PRNG
// (smol_tpu/ops/prims.py).  What differs from the TPU design:
//
// - One thread per walker.  Walkers w with the same w / block_size share a
//   row of the exogenous site sequence (the statistical contract of the
//   reference); block_size is the statistical block, independent of the
//   CUDA block size, which divides it so that a CUDA block shares one
//   sequence row.  The steps of a whole window run in a loop inside the
//   kernel.
// - The energy delta of the site, in one of three bodies (chain_common.cuh):
//   the direct lookup, one table load per local cluster:
//   t = d2 * a + sum_k stride * code(nbr), dE = sum_l g[l, t_new] - g[l, t_old];
//   or K3, the q-ary character rows: per row an integer phase over at most
//   K - 1 neighbours and two compare-selects mod q (no tensor row), the
//   rows stored sparse, not as the reference's dense frequency matrix for
//   the MXU; or K1-Ising, the parity rows of binary sign-symmetric systems:
//   per row a mask load, an AND with the walker's codes held as rank bits
//   in registers, a popcount and one f64 add (no gather of neighbour codes
//   at all).  Each is summed in native f64 in row order, then the Ewald
//   term (b - a) * (C_u + V_u . occ) in f64, then the chemical work (the
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
// window, and the proposal rank's rows (a few KB: nbr, stride, d2, g and
// the Ewald row; or the character rows) are copied into shared memory one
// step ahead with cp.async, double buffered, since the site sequence is
// known in advance (the analog of the reference's streamed-table
// prefetch).  Read straight from L2 instead, the rows cost two dependent
// L2 round trips per local cluster.
//
// The occupancy ([R, W] int8 codes, rank-major), enthalpy and accept
// counts are updated in place.  The C entry point returns
// cudaGetLastError() after the launch.

#include "chain_common.cuh"

namespace {

using namespace smol;

// Body: Direct<KT> (KT: the slot count K as a compile-time constant, 0:
// runtime K), Qary<Q, NBT> (K3) or Ising<NW> (K1-Ising, NW words of rank
// bits); EW: the tables carry the Ewald fold (ew_v [R, R], ew_c [R]).
template <class Body, bool EW>
__global__ void __launch_bounds__(kMaxThreads)
flip_chain_kernel(int8_t* __restrict__ occ, double* __restrict__ enthalpy,
                  int32_t* __restrict__ naccept,
                  const float* __restrict__ beta,
                  const int32_t* __restrict__ seq, int seq_stride,
                  const int64_t* __restrict__ seed_ptr, const Tables tables,
                  const double* __restrict__ mu,
                  const int32_t* __restrict__ ncode,
                  const double* __restrict__ ew_c, int R, int C, int W,
                  int block_size, int n_steps, int rng_mode) {
  // the tables with their compile-time counts: the slot (or neighbour)
  // count of the body and, without an Ewald term, no Ewald row
  Tables t = tables;
  Body::pin(t);
  t.RE = EW ? R : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = Body::bytes(t);
  int8_t* s_occ = reinterpret_cast<int8_t*>(smem + 2 * rb);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int w = blockIdx.x * nt + tid;
  const bool live = w < W;
  const int wc = live ? w : W - 1;  // dead threads shadow the last walker

  for (int r = 0; r < R; ++r) {
    s_occ[r * nt + tid] = occ[(size_t)r * W + wc];
  }
  typename Body::Walker wk;  // the Ising body's rank bits; nothing otherwise
  wk.load(s_occ, R, nt, tid);
  double e = enthalpy[wc];
  const float b32 = beta[wc];
  int nacc = 0;

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = (blockIdx.x * nt) / block_size;
  const int32_t* my_seq = seq + (size_t)grp * seq_stride;
  const Draws draws(*seed_ptr, grp, wc, block_size);

  if (n_steps > 0) Body::copy(smem, __ldg(my_seq), t, tid, nt);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    const typename Body::Rows rows = Body::at(smem + (i & 1) * rb, t);
    if (i + 1 < n_steps) {  // prefetch the next step's rows
      Body::copy(smem + ((i + 1) & 1) * rb, __ldg(my_seq + i + 1), t, tid, nt);
    }
    const int u = __ldg(my_seq + i);
    int8_t* cell = s_occ + u * nt + tid;
    const int a = *cell;

    const uint2 bits = draws.at(i, rng_mode);  // (r_u, r_j)
    const int nc = max(__ldg(ncode + u) - 1, 1);
    const int j = (int)(bits.y % (uint32_t)nc);
    const int b = j + (j >= a ? 1 : 0);

    const double dE = flip_delta<Body, EW>(rows, t, u, a, b, s_occ, nt, tid, R,
                                           C, mu, ew_c, wk);

    if (metropolis(b32, dE, bits.x)) {
      *cell = (int8_t)b;
      wk.set(u, b);
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

using Kernel = decltype(&flip_chain_kernel<Direct<3>, false>);

// The instantiation of a launch: the direct body with or without Ewald, K =
// 3 or runtime K; K3 for q = 2 (with or without Ewald), 3 or 4, NB = 2 or
// runtime NB;
// K1-Ising for NW = 1 to 4 words, with or without Ewald.
Kernel pick_kernel(int q, int nw, bool ew, int K, int NB) {
  switch (nw) {
    case 0: break;
    case 1: return ew ? flip_chain_kernel<Ising<1>, true> : flip_chain_kernel<Ising<1>, false>;
    case 2: return ew ? flip_chain_kernel<Ising<2>, true> : flip_chain_kernel<Ising<2>, false>;
    case 3: return ew ? flip_chain_kernel<Ising<3>, true> : flip_chain_kernel<Ising<3>, false>;
    case 4: return ew ? flip_chain_kernel<Ising<4>, true> : flip_chain_kernel<Ising<4>, false>;
    default: return nullptr;
  }
  if (q == 0) {
    return ew ? (K == 3 ? flip_chain_kernel<Direct<3>, true> : flip_chain_kernel<Direct<0>, true>)
              : (K == 3 ? flip_chain_kernel<Direct<3>, false> : flip_chain_kernel<Direct<0>, false>);
  }
  // an Ewald term needs binary sites, so K3 takes it with q = 2 only
  if (q == 2) {
    return ew ? (NB == 2 ? flip_chain_kernel<Qary<2, 2>, true> : flip_chain_kernel<Qary<2, 0>, true>)
              : (NB == 2 ? flip_chain_kernel<Qary<2, 2>, false> : flip_chain_kernel<Qary<2, 0>, false>);
  }
  if (ew) return nullptr;
  if (q == 3) return NB == 2 ? flip_chain_kernel<Qary<3, 2>, false> : flip_chain_kernel<Qary<3, 0>, false>;
  if (q == 4) return NB == 2 ? flip_chain_kernel<Qary<4, 2>, false> : flip_chain_kernel<Qary<4, 0>, false>;
  return nullptr;
}

}  // namespace

extern "C" int smol_flip_chain(void* occ, void* enthalpy, void* naccept,
                               const void* beta, const void* seq,
                               int seq_stride, const void* seed,
                               const void* nbr, const void* stride,
                               const void* d2, const void* g, const void* mu,
                               const void* ncode, const void* ew_v,
                               const void* ew_c, const void* qnbr,
                               const void* qfreq, const void* qms,
                               const void* qac, const void* qas,
                               const void* qrows, const void* imask,
                               const void* iamp, const void* irows, int R,
                               int L, int K, int TM, int C, int W,
                               int block_size, int n_steps, int rng_mode, int q,
                               int Lq, int NB, int Li, int NW, void* stream) {
  const int threads = block_threads(W, block_size);
  const bool ew = ew_v != nullptr;
  const Tables t{(const int32_t*)nbr, (const int32_t*)stride, (const int32_t*)d2,
                 (const double*)g, (const double*)ew_v, (const int32_t*)qnbr,
                 (const int32_t*)qfreq, (const int32_t*)qms, (const double*)qac,
                 (const double*)qas, (const int32_t*)qrows, L, K, TM, ew ? R : 0, Lq,
                 NB, (const uint64_t*)imask, (const double*)iamp,
                 (const int32_t*)irows, Li, NW};
  const Kernel kernel = pick_kernel(q, NW, ew, K, NB);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t rb = NW > 0   ? Ising<1>::bytes(t)
                    : q == 0 ? Direct<0>::bytes(t)
                             : Qary<2, 0>::bytes(t);
  const size_t smem = 2 * rb + (size_t)R * threads;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (W + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (int8_t*)occ, (double*)enthalpy, (int32_t*)naccept, (const float*)beta,
      (const int32_t*)seq, seq_stride, (const int64_t*)seed, t,
      (const double*)mu, (const int32_t*)ncode, (const double*)ew_c, R, C, W,
      block_size, n_steps, rng_mode);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

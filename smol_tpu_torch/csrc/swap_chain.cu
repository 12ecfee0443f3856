// Shared-proposal canonical swap Metropolis chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU chain kernel of smol_tpu/ops/pallas_chain.py
// (make_shared_proposal_chain, move="swap": the swap branch of `step`
// :1814-1838 with make_swap_pair_delta / _ising / _qary, the Ewald term
// ewald_delta (K4), the accept :1882-1898 and the non-null move count).
// It keeps flip_chain.cu's frame (one thread per walker, the block's codes
// in shared memory for the whole window, Philox or the reference's hash,
// the direct, the q-ary or the Ising site body of chain_common.cuh):
//
// - Each step takes a pair (u, v) of ranks of one sublattice from two
//   exogenous sequences shared by the walkers of a group.  With a = occ[u],
//   b = occ[v], the proposal gives u code b and v code a.  A null pair
//   (a == b, which includes u == v) leaves the occupancy as it is and is
//   never accepted; the others are counted in nmove.
// - The joint delta is exact: u's clusters going a -> b, then v's going
//   b -> a against the occupancy with u already holding b (b is written
//   into u's shared cell for that, and a put back on reject), then u's
//   Ewald term (b - a) * (C_u + V_u . occ), then v's, (a - b) * (C_v +
//   V_v . occ with u holding b) (:1830-1838).  Summed in f64 in that order,
//   as the plain torch twin in ops/chain.py sums.  With the q-ary body, v's
//   phases read u's new code from its cell, which takes the place of the
//   reference's rank-1 correction of v's phases (:596-603), and with the
//   Ising body v's parities read the walker's bits with u's set to b
//   (:427-432): one site body serves both moves.
// - The acceptance uniform is the only draw of a swap: r_u, slot 1 of the
//   hash, word x of Philox (the reference :1862-1863).
//
// What bounds it on this card: as for the flip chain, the latency of each
// walker's dependent step, not the roofline.  A swap reads twice the rows
// of a flip (u's and v's), and with Ewald two dots of R terms.  Both ranks
// are known in advance, so the rows of the next step's u and v (nbr,
// stride, d2, g, Ewald row; or the character rows) are copied into shared
// memory with cp.async, double buffered.
//
// The occupancy ([R, W] int8 codes, rank-major), enthalpy, accept and move
// counts are updated in place.  The C entry point returns
// cudaGetLastError() after the launch.

#include "chain_common.cuh"

namespace {

using namespace smol;

// Body: Direct<KT> (KT: the slot count K as a compile-time constant, 0:
// runtime K), Qary<Q, NBT> (K3) or Ising<NW> (K1-Ising); EW: the tables
// carry the Ewald fold (ew_v [R, R], ew_c [R]).
template <class Body, bool EW>
__global__ void __launch_bounds__(kMaxThreads)
swap_chain_kernel(int8_t* __restrict__ occ, double* __restrict__ enthalpy,
                  int32_t* __restrict__ naccept, int32_t* __restrict__ nmove,
                  const float* __restrict__ beta,
                  const int32_t* __restrict__ useq,
                  const int32_t* __restrict__ vseq, int seq_stride,
                  const int64_t* __restrict__ seed_ptr,
                  const int32_t* __restrict__ nbr,
                  const int32_t* __restrict__ stride,
                  const int32_t* __restrict__ d2,
                  const double* __restrict__ g,
                  const double* __restrict__ ew_v,
                  const double* __restrict__ ew_c,
                  const int32_t* __restrict__ qnbr,
                  const int32_t* __restrict__ qfreq,
                  const int32_t* __restrict__ qms,
                  const double* __restrict__ qac,
                  const double* __restrict__ qas,
                  const int32_t* __restrict__ qrows,
                  const uint64_t* __restrict__ imask,
                  const double* __restrict__ iamp,
                  const int32_t* __restrict__ irows, int R, int L, int K,
                  int TM, int Lq, int NB, int Li, int NW, int W,
                  int block_size, int n_steps, int rng_mode) {
  // the tables with their compile-time counts: the slot (or neighbour)
  // count of the body and, without an Ewald term, no Ewald row.  The
  // pointers come in as __restrict__ parameters: taken from a Tables
  // parameter instead, the window on the Ewald cells ran 10 % slower (A/B
  // on an H100, scripts/time_chain_windows.py)
  Tables t{nbr, stride, d2, g, ew_v, qnbr, qfreq, qms, qac, qas, qrows,
           L, K, TM, EW ? R : 0, Lq, NB, imask, iamp, irows, Li, NW};
  Body::pin(t);
  extern __shared__ __align__(16) unsigned char smem[];
  // two slots (this step, next step), each the rows of u then of v
  const size_t rb = Body::bytes(t);
  int8_t* s_occ = reinterpret_cast<int8_t*>(smem + 4 * rb);

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
  int nmv = 0;

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = (blockIdx.x * nt) / block_size;
  const int32_t* my_useq = useq + (size_t)grp * seq_stride;
  const int32_t* my_vseq = vseq + (size_t)grp * seq_stride;
  const Draws draws(*seed_ptr, grp, wc, block_size);

  auto prefetch = [&](int i) {  // step i's rows of u and v into slot i & 1
    unsigned char* slot = smem + (i & 1) * 2 * rb;
    Body::copy(slot, __ldg(my_useq + i), t, tid, nt);
    Body::copy(slot + rb, __ldg(my_vseq + i), t, tid, nt);
  };
  if (n_steps > 0) prefetch(0);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    unsigned char* slot = smem + (i & 1) * 2 * rb;
    const typename Body::Rows ru = Body::at(slot, t);
    const typename Body::Rows rv = Body::at(slot + rb, t);
    if (i + 1 < n_steps) prefetch(i + 1);

    const int u = __ldg(my_useq + i);
    const int v = __ldg(my_vseq + i);
    int8_t* cu = s_occ + u * nt + tid;
    int8_t* cv = s_occ + v * nt + tid;
    const int a = *cu;
    const int b = *cv;
    const bool is_move = a != b;

    // leaves b in u's cell: v's delta sees u already holding b
    const double dE = swap_delta<Body, EW>(ru, rv, t, u, v, cu, a, b, s_occ, nt,
                                           tid, R, ew_c, wk);

    if (is_move && metropolis(b32, dE, draws.at(i, rng_mode).x)) {
      *cv = (int8_t)a;
      wk.set(u, b);
      wk.set(v, a);
      e += dE;
      ++nacc;
    } else {
      *cu = (int8_t)a;
    }
    nmv += is_move ? 1 : 0;
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  if (live) {
    for (int r = 0; r < R; ++r) {
      occ[(size_t)r * W + w] = s_occ[r * nt + tid];
    }
    enthalpy[w] = e;
    naccept[w] += nacc;
    nmove[w] += nmv;
  }
}

using Kernel = decltype(&swap_chain_kernel<Direct<3>, false>);

// The instantiation of a launch, as flip_chain.cu picks it.
Kernel pick_kernel(int q, int nw, bool ew, int K, int NB) {
  switch (nw) {
    case 0: break;
    case 1: return ew ? swap_chain_kernel<Ising<1>, true> : swap_chain_kernel<Ising<1>, false>;
    case 2: return ew ? swap_chain_kernel<Ising<2>, true> : swap_chain_kernel<Ising<2>, false>;
    case 3: return ew ? swap_chain_kernel<Ising<3>, true> : swap_chain_kernel<Ising<3>, false>;
    case 4: return ew ? swap_chain_kernel<Ising<4>, true> : swap_chain_kernel<Ising<4>, false>;
    default: return nullptr;
  }
  if (q == 0) {
    return ew ? (K == 3 ? swap_chain_kernel<Direct<3>, true> : swap_chain_kernel<Direct<0>, true>)
              : (K == 3 ? swap_chain_kernel<Direct<3>, false> : swap_chain_kernel<Direct<0>, false>);
  }
  // an Ewald term needs binary sites, so K3 takes it with q = 2 only
  if (q == 2) {
    return ew ? (NB == 2 ? swap_chain_kernel<Qary<2, 2>, true> : swap_chain_kernel<Qary<2, 0>, true>)
              : (NB == 2 ? swap_chain_kernel<Qary<2, 2>, false> : swap_chain_kernel<Qary<2, 0>, false>);
  }
  if (ew) return nullptr;
  if (q == 3) return NB == 2 ? swap_chain_kernel<Qary<3, 2>, false> : swap_chain_kernel<Qary<3, 0>, false>;
  if (q == 4) return NB == 2 ? swap_chain_kernel<Qary<4, 2>, false> : swap_chain_kernel<Qary<4, 0>, false>;
  return nullptr;
}

}  // namespace

extern "C" int smol_swap_chain(void* occ, void* enthalpy, void* naccept,
                               void* nmove, const void* beta, const void* useq,
                               const void* vseq, int seq_stride,
                               const void* seed, const void* nbr,
                               const void* stride, const void* d2,
                               const void* g, const void* ew_v,
                               const void* ew_c, const void* qnbr,
                               const void* qfreq, const void* qms,
                               const void* qac, const void* qas,
                               const void* qrows, const void* imask,
                               const void* iamp, const void* irows, int R,
                               int L, int K, int TM, int W, int block_size,
                               int n_steps, int rng_mode, int q, int Lq, int NB,
                               int Li, int NW, void* stream) {
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
  const size_t smem = 4 * rb + (size_t)R * threads;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (W + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (int8_t*)occ, (double*)enthalpy, (int32_t*)naccept, (int32_t*)nmove,
      (const float*)beta, (const int32_t*)useq, (const int32_t*)vseq,
      seq_stride, (const int64_t*)seed, t.nbr, t.stride, t.d2, t.g, t.ew_v,
      (const double*)ew_c, t.qnbr, t.qfreq, t.qms, t.qac, t.qas, t.qrows,
      t.imask, t.iamp, t.irows, R, L, K, TM, Lq, NB, Li, NW, W, block_size,
      n_steps, rng_mode);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

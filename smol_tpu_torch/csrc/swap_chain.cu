// Shared-proposal canonical swap Metropolis chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU chain kernel of smol_tpu/ops/pallas_chain.py
// (make_shared_proposal_chain, move="swap": the swap branch of `step`
// :1814-1838 with make_swap_pair_delta / _ising / _qary, the Ewald term
// ewald_delta (K4), the accept :1882-1898 and the non-null move count).
// It keeps flip_chain.cu's frame (lanes, the block's codes in shared
// memory for the whole window, Philox or the reference's hash, the
// direct, the q-ary or the Ising site body of chain_common.cuh):
//
// - Each step takes a pair (u, v) of ranks of one sublattice from two
//   exogenous sequences shared by the walkers of a group.  With a = occ[u],
//   b = occ[v], the proposal gives u code b and v code a.  A null pair
//   (a == b, which includes u == v) leaves the occupancy as it is and is
//   never accepted, so its delta is not computed; the others are counted
//   in nmove.
// - The joint delta is exact: u's clusters going a -> b, then v's going
//   b -> a against the occupancy with u already holding b (b is written
//   into u's shared cell for that, and a put back on reject), then u's
//   Ewald term (b - a) * (C_u + V_u . occ), then v's, (a - b) * (C_v +
//   V_v . occ with u holding b) (:1830-1838).  Summed in f64 in that order,
//   as the plain torch twin in ops/chain.py sums (lane_swap_delta in
//   chain_common.cuh, shared with wl_chain.cu).  With the q-ary body, v's
//   phases read u's new code from its cell, which takes the place of the
//   reference's rank-1 correction of v's phases (:596-603), and with the
//   Ising body v's parities read the walker's bits with u's set to b
//   (:427-432): one site body serves both moves.
// - The acceptance uniform is the only draw of a swap: r_u, slot 1 of the
//   hash, word x of Philox (the reference :1862-1863).
//
// Lanes.  A walker is G consecutive threads of one warp (G = 1, 2, 4, 8 or
// 16, `lanes`; ops/chain.py launch_plan picks it from the launch's walkers
// and the site body), and a block holds `walkers_per_block` walkers of one
// sequence group (at most 256 threads), their codes in shared memory
// [R][code_pitch].  Lane j takes rows j, j + G, ... of u's rows and then
// of v's (the direct and K3 rows in batches of kRowBatch, K1-Ising's in
// batches of kLaneBatch), the partials meeting in a butterfly of
// __shfl_xor_sync.  The step's uniform is drawn G steps at a time, one
// step a lane, and read with a shuffle, as in flip_chain.cu; the pair is
// read each step.  Every lane takes the decision and keeps its own copy of
// the enthalpy and, for K1-Ising, the rank bits; lane 0 alone writes
// codes, behind __syncwarp over the walker's lanes.  The Ewald dot is split
// over the lanes too: lane j takes ranks j, j + G, ..., meeting in the
// butterfly (in rank order on every lane, as K1 and K6 take it, it ran
// 1.19-1.96x slower on an H100, PERF.md).  At G = 1 the rows and the dot
// are summed in order, as the one-thread kernel did.  The frame (the
// walker's lanes, the codes' load and store, the split draw) is
// chain_common.cuh's LaneFrame, shared with the flip, table and
// Wang-Landau chains.
//
// Rows.  Where every rank's rows of the body fit in shared memory beside
// the codes, the launch runs at least a step a rank and the rows add no
// wave of blocks over the SMs (`resident`, ops/chain.py launch_plan; the
// K1-Ising rows of the spinel CE + Ewald 2x2x2 on a 100-step window), the
// block copies them once with cp.async and runs every step with no block
// barrier.  Otherwise the rows of the next
// step's u and v are streamed into a second pair of buffers with cp.async
// while this step runs (K8), behind one block barrier a step.
//
// What bounds it on this card: not the roofline (chip_smoke.py's bound),
// but each walker's dependent step: at one thread a walker, in blocks of
// 64, a launch of 8192 walkers put about two warps on an SM, each walking
// two ranks' rows in turn.  The lanes divide the rows by G and put G times
// more warps on the card; what every lane repeats (the pair, the decision,
// the shuffles) stays.
//
// The occupancy ([R, W] int8 codes, rank-major), enthalpy, accept and move
// counts are updated in place.  The C entry point returns
// cudaGetLastError() after the launch.

#include "chain_common.cuh"

namespace {

using namespace smol;

constexpr int kSwapThreads = 256;  // most threads of a block: walkers x lanes
constexpr int kRowBatch = 4;  // direct and K3 rows a lane loads before it adds them

// Dynamic shared memory of one launch: the rows (every rank's, or two
// buffers of u's and v's) and the block's codes.
size_t shared_bytes(size_t rb, int R, int walkers_per_block, int resident) {
  return (resident ? (size_t)R : 4) * rb + align16((size_t)R * code_pitch(walkers_per_block));
}

// Body: Direct<KT> (KT: the slot count K as a compile-time constant, 0:
// runtime K), Qary<Q, NBT> (K3) or Ising<NW> (K1-Ising); EW: the tables
// carry the Ewald fold (ew_v [R, R], ew_c [R]).
template <class Body, bool EW>
__global__ void __launch_bounds__(kSwapThreads)
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
                  int block_size, int n_steps, int rng_mode, int lanes,
                  int walkers_per_block, int resident) {
  // the tables with their compile-time counts: the slot (or neighbour)
  // count of the body and, without an Ewald term, no Ewald row.  The
  // pointers come in as __restrict__ parameters: taken from a Tables
  // parameter instead, the window on the Ewald cells ran 10 % slower (A/B
  // on an H100 at one thread a walker, scripts/time_chain_windows.py)
  Tables t{nbr, stride, d2, g, ew_v, qnbr, qfreq, qms, qac, qas, qrows,
           L, K, TM, EW ? R : 0, Lq, NB, imask, iamp, irows, Li, NW};
  Body::pin(t);
  const LaneFrame f(lanes, walkers_per_block, W);
  const int tid = f.tid, nt = f.nt, lane = f.lane, pitch = f.pitch;
  const unsigned mask = f.mask;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = Body::bytes(t);
  int8_t* s_occ = reinterpret_cast<int8_t*>(smem + (resident ? (size_t)R : 4) * rb);
  f.load_codes(s_occ, occ, R);
  int8_t* codes = s_occ + f.wl;  // the walker's column of the codes

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = f.w0 / block_size;
  const int32_t* my_useq = useq + (size_t)grp * seq_stride;
  const int32_t* my_vseq = vseq + (size_t)grp * seq_stride;
  const Draws draws(*seed_ptr, grp, f.wc, block_size);

  auto prefetch = [&](int i) {  // step i's rows of u and v into buffers 2 (i & 1) + {0, 1}
    unsigned char* buf = smem + (i & 1) * 2 * rb;
    Body::copy(buf, __ldg(my_useq + i), t, tid, nt);
    Body::copy(buf + rb, __ldg(my_vseq + i), t, tid, nt);
  };
  if (resident) {
    for (int r = 0; r < R; ++r) Body::copy(smem + r * rb, r, t, tid, nt);
  } else if (n_steps > 0) {
    prefetch(0);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  typename Body::Walker wk;  // the Ising body's rank bits; nothing otherwise
  wk.load(s_occ, R, pitch, f.wl);
  double e = enthalpy[f.wc];
  const float b32 = beta[f.wc];
  int nacc = 0;
  int nmv = 0;

  float my_logu = 0.0f;  // log U, drawn G steps at a time (lane_log_u)
  for (int i = 0; i < n_steps; ++i) {
    if (!resident && i + 1 < n_steps) prefetch(i + 1);
    // a dead walker's lanes only copy rows and meet the block's barrier
    if (f.live) {
      const float log_u = lane_log_u(my_logu, draws, i, n_steps, rng_mode, f);
      const int u = __ldg(my_useq + i);
      const int v = __ldg(my_vseq + i);
      const size_t bu = resident ? (size_t)u : (size_t)(i & 1) * 2;
      const size_t bv = resident ? (size_t)v : (size_t)(i & 1) * 2 + 1;
      int8_t* cu = codes + u * pitch;
      int8_t* cv = codes + v * pitch;
      const int a = *cu;
      const int b = *cv;
      const bool is_move = a != b;
      if (is_move) {
        // leaves b in u's cell: v's delta sees u already holding b
        const double dE = lane_swap_delta<Body, EW, kRowBatch, true>(
            Body::at(smem + bu * rb, t), Body::at(smem + bv * rb, t), t, u, v, cu, a, b,
            codes, pitch, R, ew_c, wk, lane, lanes, mask);
        __syncwarp(mask);  // every lane has read the codes
        // the Metropolis decision in f32, as metropolis() takes it
        const float expo = -b32 * (float)dE;
        if (expo >= 0.0f || expo > log_u) {
          if (lane == 0) *cv = (int8_t)a;
          wk.set(u, b);
          wk.set(v, a);
          e += dE;
          ++nacc;
        } else if (lane == 0) {
          *cu = (int8_t)a;
        }
        ++nmv;
      }
      __syncwarp(mask);  // this step's writes, before the next step's reads
    }
    if (!resident) {
      __pipeline_wait_prior(0);
      __syncthreads();
    }
  }

  __syncthreads();
  f.store_codes(occ, s_occ, R);
  if (f.live && lane == 0) {
    enthalpy[f.w] = e;
    naccept[f.w] += nacc;
    nmove[f.w] += nmv;
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
                               int Li, int NW, int lanes, int walkers_per_block,
                               int resident, void* stream) {
  if (!lane_launch_ok(W, lanes, walkers_per_block, block_size, kSwapThreads, resident)) {
    return (int)cudaErrorInvalidValue;
  }
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
  const size_t smem = shared_bytes(rb, R, walkers_per_block, resident);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (W + walkers_per_block - 1) / walkers_per_block;
  kernel<<<blocks, walkers_per_block * lanes, smem, (cudaStream_t)stream>>>(
      (int8_t*)occ, (double*)enthalpy, (int32_t*)naccept, (int32_t*)nmove,
      (const float*)beta, (const int32_t*)useq, (const int32_t*)vseq,
      seq_stride, (const int64_t*)seed, t.nbr, t.stride, t.d2, t.g, t.ew_v,
      (const double*)ew_c, t.qnbr, t.qfreq, t.qms, t.qac, t.qas, t.qrows,
      t.imask, t.iamp, t.irows, R, L, K, TM, Lq, NB, Li, NW, W, block_size,
      n_steps, rng_mode, lanes, walkers_per_block, resident);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

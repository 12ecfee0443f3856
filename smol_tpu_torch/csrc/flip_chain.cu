// Shared-proposal single-flip Metropolis chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU chain kernel of smol_tpu/ops/pallas_chain.py
// (make_shared_proposal_chain, move="flip": `kernel` and `step`), with its
// site delta (make_site_delta / make_site_delta_ising /
// make_site_delta_qary), Ewald term (ewald_delta, K4), chemical work
// (mu_work) and Metropolis accept, and the TPU's hardware PRNG
// (smol_tpu/ops/prims.py).  What differs from the TPU design:
//
// - Walkers w with the same w / block_size share a row of the exogenous
//   site sequence (the statistical contract of the reference); block_size
//   is the statistical block, independent of the CUDA block, which lies
//   inside one sequence group.  The steps of a whole window run in a loop
//   inside the kernel.
// - The energy delta of the site, in one of three bodies (chain_common.cuh):
//   the direct lookup, one table load per local cluster:
//   t = d2 * a + sum_k stride * code(nbr), dE = sum_l g[l, t_new] - g[l, t_old];
//   or K3, the q-ary character rows: per row an integer phase over at most
//   K - 1 neighbours and two compare-selects mod q (no tensor row), the
//   rows stored sparse, not as the reference's dense frequency matrix for
//   the MXU; or K1-Ising, the parity rows of binary sign-symmetric systems:
//   per row a mask load, an AND with the walker's codes held as rank bits
//   in registers, a popcount and one f64 add (no gather of neighbour codes
//   at all).  Each is summed in native f64, then the Ewald term
//   (b - a) * (C_u + V_u . occ) in f64 in rank order, then the chemical
//   work (the reference needs double-float pairs and select loops because a
//   TPU has no f64 vector unit and slow gathers, and takes the Ewald dot in
//   f32).  The plain torch twin in ops/chain.py sums in the same order, so
//   both give the same f64 delta.
// - The acceptance exponent is taken in f32, as the reference does, so
//   trajectories can be compared with it; the enthalpy accumulates in f64.
// - Random numbers: Philox4x32-10 keyed by (seed, walker) with the step as
//   counter in run mode, or the reference's interpret-mode hash of
//   (seed, step, slot, lane) bit for bit in hash mode.
//
// Lanes.  A walker is G consecutive threads of one warp (G = 1, 2, 4, 8 or
// 16, `lanes`; ops/chain.py flip_launch_plan picks it from the launch's
// walkers and the site body), and a block holds `walkers_per_block`
// walkers of one sequence group (at most 256 threads), their codes in
// shared memory [R][code_pitch], one byte a walker, the padded pitch
// putting the rows of different ranks in different banks.  Lane j takes
// rows j, j + G, j + 2G, ... of the proposal rank's rows (the direct and
// K3 rows in batches of kRowBatch, K1-Ising's in batches of kLaneBatch,
// whose loads are issued before the terms are added in row order, from
// +0.0); the G partials meet in a butterfly of __shfl_xor_sync, after
// which every lane holds the same dE bits (Lanes<Body>, lane_flip_delta in
// chain_common.cuh, shared with wl_chain.cu).  What a step needs before
// its rows is drawn G steps at a time, one step a lane (the rank, its code
// count, the Philox or hash bits and log U), and read with a shuffle, so a
// lane draws once every G steps.  Every lane takes the Metropolis decision
// and keeps its own copy of the walker's enthalpy and, for K1-Ising, rank
// bits; lane 0 alone writes the code, behind __syncwarp over the walker's
// lanes.  The Ewald dot stays in rank order on every lane.  At G = 1 the
// same code sums the rows in row order, as the one-thread kernel did.
//
// Rows.  Where every rank's rows of the body fit in shared memory beside
// the codes and the launch runs at least a step a rank (`resident`;
// flip_launch_plan decides from the shapes: the K1-Ising rows of the spinel
// 2x2x2, about 45 KB, and of Au-Cu 3x3x3, about 50 KB, on a 100-step
// window), the block copies them once with cp.async and runs every step
// with no block barrier.  Otherwise (K3's and the direct rows of `sgc` 6x6x6,
// about 12 and 25 KB a rank over 216 ranks) the next step's rows are
// streamed into a second buffer with cp.async while this step runs (K8),
// behind one block barrier a step, since the site sequence is known in
// advance (the analog of the reference's streamed-table prefetch).
//
// What bounds it on this card: not the roofline (chip_smoke.py's bound:
// the kernel stays 30-130 times above it, PERF.md), but each walker's
// dependent steps.  At one thread a walker, in blocks of 64, a launch of
// 8192 walkers put about two warps on an SM, each walking its rank's rows
// in turn (K3 on `sgc`: 336 rows a step).  The lanes divide the rows by G
// and put G times more warps on the card, the batches put several rows'
// loads in flight, the resident rows drop the per-step cp.async wait and
// block barrier.  At the plan's G the step is bound by the SM's issue of
// the work every lane repeats and of the rows, not by latency: twice the
// lanes (twice the warps) ran slower on every cell measured.
//
// The window (smol_flip_window).  A tempering window of the reference
// (smol_tpu/parallel/tempering.py:82-106) is a lax.scan of segments of
// `period` steps with an exchange sweep after each, which XLA compiles as
// one program.  Here it is one cooperative launch of the same kernel
// (WINDOW): segment s reads row s of the sequences and seed s, as the s-th
// launch of the segment-by-segment path reads them, and the codes stay in
// shared memory, the Ising rank bits in registers, the rows (where
// resident) in shared memory, across all segments.  After segment s every
// walker writes its enthalpy and f64 beta into a snapshot of parity s % 2,
// the grid meets at one barrier (cooperative_groups' grid.sync), and every
// walker takes its own pair's decision with phase (phase0 + s) % 2 on row s
// of the uniforms: the left member and the right one read the same two
// betas, two enthalpies and u_l and call the same exchange_accept
// (chain_common.cuh), so both reach the same bits, and each takes its new
// beta (f64 in a register, f32 for the next segment's Metropolis test)
// without writing its partner's.  The snapshots alternate by parity, so a
// walker that writes segment s + 1's values never overwrites what a slower
// walker still reads of segment s: the barrier after s + 1 comes only after
// every read of s.  Only the left member counts an accepted exchange.  At
// the window's end the kernel writes the codes, enthalpy, accept counts,
// beta, beta32 and exchange counts as the segment launches and exchange
// launches (tempering.cu) leave them, bit for bit.  The launch needs every
// block resident at once: ops/chain.py tempering_window_plan asks
// smol_flip_window_blocks_per_sm (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// before it takes this path, and a cooperative launch that fails returns
// its error, which the caller raises.
//
// The occupancy ([R, W] int8 codes, rank-major), enthalpy and accept
// counts are updated in place.  The C entry points return
// cudaGetLastError() after the launch.

#include <cooperative_groups.h>

#include "chain_common.cuh"

namespace {

using namespace smol;

constexpr int kFlipThreads = 256;  // most threads of a block: walkers x lanes
constexpr int kRowBatch = 4;  // direct and K3 rows a lane loads before it adds them

// Dynamic shared memory of one launch: the rows (every rank's, or two
// buffers of one rank's) and the block's codes.
size_t shared_bytes(size_t rb, int R, int walkers_per_block, int resident) {
  return (resident ? (size_t)R : 2) * rb +
         align16((size_t)R * code_pitch(walkers_per_block));
}

// A window's operands beside the chain's (WINDOW only).
struct Window {
  double* beta;            // [W] f64 inverse temperatures, in and out
  double* snap;            // [2][2][W] f64: by segment parity, enthalpies then betas
  const double* uniforms;  // [n_segments, W] f64 exchange uniforms
  int32_t* accepted;       // [W] accepted exchanges, at each pair's left member; or null
  int64_t seq_segment;     // elements from one segment's sequence rows to the next
  int n_segments;
  int phase0;              // phase of the first exchange
};

// Body: Direct<KT> (KT: the slot count K as a compile-time constant, 0:
// runtime K), Qary<Q, NBT> (K3) or Ising<NW> (K1-Ising, NW words of rank
// bits); EW: the tables carry the Ewald fold (ew_v [R, R], ew_c [R]);
// WINDOW: a tempering window of win.n_segments segments with an exchange
// after each, launched cooperatively (else one segment, win unread).
template <class Body, bool EW, bool WINDOW>
__global__ void __launch_bounds__(kFlipThreads)
flip_chain_kernel(int8_t* __restrict__ occ, double* __restrict__ enthalpy,
                  int32_t* __restrict__ naccept,
                  float* __restrict__ beta,
                  const int32_t* __restrict__ seq, int seq_stride,
                  const int64_t* __restrict__ seed_ptr, const Tables tables,
                  const double* __restrict__ mu,
                  const int32_t* __restrict__ ncode,
                  const double* __restrict__ ew_c, int R, int C, int W,
                  int block_size, int n_steps, int rng_mode, int lanes,
                  int walkers_per_block, int resident, const Window win) {
  // the tables with their compile-time counts: the slot (or neighbour)
  // count of the body and, without an Ewald term, no Ewald row
  Tables t = tables;
  Body::pin(t);
  t.RE = EW ? R : 0;
  const LaneFrame f(lanes, walkers_per_block, W);
  const int tid = f.tid, nt = f.nt, lane = f.lane, pitch = f.pitch;
  const unsigned mask = f.mask;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = Body::bytes(t);
  int8_t* s_occ = reinterpret_cast<int8_t*>(smem + (resident ? (size_t)R : 2) * rb);
  f.load_codes(s_occ, occ, R);
  int8_t* codes = s_occ + f.wl;  // the walker's column of the codes

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = f.w0 / block_size;
  const int segments = WINDOW ? win.n_segments : 1;
  const int32_t* my_seq = seq + (size_t)grp * seq_stride;  // segment 0's row

  if (resident) {
    for (int r = 0; r < R; ++r) Body::copy(smem + r * rb, r, t, tid, nt);
  } else if (n_steps > 0) {
    Body::copy(smem, __ldg(my_seq), t, tid, nt);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  typename Body::Walker wk;  // the Ising body's rank bits; nothing otherwise
  wk.load(s_occ, R, pitch, f.wl);
  double e = enthalpy[f.wc];
  float b32 = beta[f.wc];
  double b64 = 0.0;  // WINDOW: the walker's f64 beta
  if constexpr (WINDOW) b64 = win.beta[f.wc];
  int nacc = 0, nexch = 0;

  for (int s = 0; s < segments; ++s) {
    if (WINDOW && s > 0) {
      my_seq += win.seq_segment;
      if (!resident && n_steps > 0) {  // the segment's first rows
        Body::copy(smem, __ldg(my_seq), t, tid, nt);
        __pipeline_wait_prior(0);
        __syncthreads();
      }
    }
    const Draws draws(seed_ptr[s], grp, f.wc, block_size);

    // what a step needs before its rows, drawn G steps at a time: lane j
    // takes step i + j (its rank, the rank's other codes, r_j and log U),
    // and step i reads them from lane i % G
    int my_u = 0, my_nc = 1;
    uint32_t my_rj = 0;
    float my_logu = 0.0f;
    for (int i = 0; i < n_steps; ++i) {
      if (!resident && i + 1 < n_steps) {  // prefetch the next step's rows
        Body::copy(smem + ((i + 1) & 1) * rb, __ldg(my_seq + i + 1), t, tid, nt);
      }
      // a dead walker's lanes only copy rows and meet the block's barrier
      if (f.live) {
        const int slot = i & (lanes - 1);
        if (slot == 0 && i + lane < n_steps) {
          const uint2 bits = draws.at(i + lane, rng_mode);  // (r_u, r_j)
          my_u = __ldg(my_seq + i + lane);
          my_nc = max(__ldg(ncode + my_u) - 1, 1);
          my_rj = bits.y;
          my_logu = log_uniform(bits.x);
        }
        const int u = __shfl_sync(mask, my_u, slot, lanes);
        const int nc = __shfl_sync(mask, my_nc, slot, lanes);
        const uint32_t r_j = __shfl_sync(mask, my_rj, slot, lanes);
        const float log_u = __shfl_sync(mask, my_logu, slot, lanes);
        const typename Body::Rows rows =
            Body::at(smem + (resident ? (size_t)u : (size_t)(i & 1)) * rb, t);
        int8_t* cell = codes + u * pitch;
        const int a = *cell;
        const int j = (int)(r_j % (uint32_t)nc);
        const int b = j + (j >= a ? 1 : 0);

        const double dE = lane_flip_delta<Body, EW, kRowBatch>(
            rows, t, u, a, b, codes, pitch, R, C, mu, ew_c, wk, lane, lanes, mask);
        __syncwarp(mask);  // every lane has read the codes
        // the Metropolis decision in f32, as metropolis() takes it
        const float expo = -b32 * (float)dE;
        if (expo >= 0.0f || expo > log_u) {
          if (lane == 0) *cell = (int8_t)b;
          wk.set(u, b);
          e += dE;
          ++nacc;
        }
        __syncwarp(mask);  // this step's write, before the next step's reads
      }
      if (!resident) {
        __pipeline_wait_prior(0);
        __syncthreads();
      }
    }

    if constexpr (WINDOW) {  // the exchange after segment s
      double* h_snap = win.snap + (size_t)(s & 1) * 2 * W;
      double* b_snap = h_snap + W;
      if (f.live && lane == 0) {
        h_snap[f.w] = e;
        b_snap[f.w] = b64;
      }
      cooperative_groups::this_grid().sync();
      const int phase = (win.phase0 + s) & 1;
      const bool left = ((f.w - phase) & 1) == 0;
      const int l = left ? f.w : f.w - 1;
      if (f.live && l >= 0 && l + 1 < W) {
        // what another block wrote before the barrier: read past L1
        const double other_b = __ldcg(b_snap + (left ? l + 1 : l));
        const double other_h = __ldcg(h_snap + (left ? l + 1 : l));
        const double bl = left ? b64 : other_b, br = left ? other_b : b64;
        const double hl = left ? e : other_h, hr = left ? other_h : e;
        if (exchange_accept(bl, br, hl, hr, __ldg(win.uniforms + (size_t)s * W + l))) {
          b64 = other_b;
          b32 = (float)other_b;
          nexch += left;
        }
      }
    }
  }

  __syncthreads();
  f.store_codes(occ, s_occ, R);
  if (f.live && lane == 0) {
    enthalpy[f.w] = e;
    naccept[f.w] += nacc;
    if constexpr (WINDOW) {
      win.beta[f.w] = b64;
      beta[f.w] = b32;
      if (win.accepted != nullptr) win.accepted[f.w] += nexch;
    }
  }
}

using Kernel = decltype(&flip_chain_kernel<Direct<3>, false, false>);

// The instantiation of a launch: the direct body with or without Ewald, K =
// 3 or runtime K; K3 for q = 2 (with or without Ewald), 3 or 4, NB = 2 or
// runtime NB;
// K1-Ising for NW = 1 to 4 words, with or without Ewald.  WIN: the window.
template <bool WIN>
Kernel pick_kernel(int q, int nw, bool ew, int K, int NB) {
  switch (nw) {
    case 0: break;
    case 1: return ew ? flip_chain_kernel<Ising<1>, true, WIN> : flip_chain_kernel<Ising<1>, false, WIN>;
    case 2: return ew ? flip_chain_kernel<Ising<2>, true, WIN> : flip_chain_kernel<Ising<2>, false, WIN>;
    case 3: return ew ? flip_chain_kernel<Ising<3>, true, WIN> : flip_chain_kernel<Ising<3>, false, WIN>;
    case 4: return ew ? flip_chain_kernel<Ising<4>, true, WIN> : flip_chain_kernel<Ising<4>, false, WIN>;
    default: return nullptr;
  }
  if (q == 0) {
    return ew ? (K == 3 ? flip_chain_kernel<Direct<3>, true, WIN> : flip_chain_kernel<Direct<0>, true, WIN>)
              : (K == 3 ? flip_chain_kernel<Direct<3>, false, WIN> : flip_chain_kernel<Direct<0>, false, WIN>);
  }
  // an Ewald term needs binary sites, so K3 takes it with q = 2 only
  if (q == 2) {
    return ew ? (NB == 2 ? flip_chain_kernel<Qary<2, 2>, true, WIN> : flip_chain_kernel<Qary<2, 0>, true, WIN>)
              : (NB == 2 ? flip_chain_kernel<Qary<2, 2>, false, WIN> : flip_chain_kernel<Qary<2, 0>, false, WIN>);
  }
  if (ew) return nullptr;
  if (q == 3) return NB == 2 ? flip_chain_kernel<Qary<3, 2>, false, WIN> : flip_chain_kernel<Qary<3, 0>, false, WIN>;
  if (q == 4) return NB == 2 ? flip_chain_kernel<Qary<4, 2>, false, WIN> : flip_chain_kernel<Qary<4, 0>, false, WIN>;
  return nullptr;
}

// One launch of a segment (window == false: a plain launch) or of a window
// (a cooperative launch, every block resident at once).
int launch(bool window, void* occ, void* enthalpy, void* naccept, void* beta,
           const void* seq, int seq_stride, const void* seed, const Tables& t,
           const void* mu, const void* ncode, const void* ew_c, int R, int C, int W,
           int block_size, int n_steps, int rng_mode, int q, int lanes,
           int walkers_per_block, int resident, const Window& win, void* stream) {
  if (!lane_launch_ok(W, lanes, walkers_per_block, block_size, kFlipThreads, resident)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool ew = t.ew_v != nullptr;
  const Kernel kernel = window ? pick_kernel<true>(q, t.NW, ew, t.K, t.NB)
                               : pick_kernel<false>(q, t.NW, ew, t.K, t.NB);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t rb = t.NW > 0 ? Ising<1>::bytes(t)
                    : q == 0 ? Direct<0>::bytes(t)
                             : Qary<2, 0>::bytes(t);
  const size_t smem = shared_bytes(rb, R, walkers_per_block, resident);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (W + walkers_per_block - 1) / walkers_per_block;
  int8_t* occ_ = (int8_t*)occ;
  double* enthalpy_ = (double*)enthalpy;
  int32_t* naccept_ = (int32_t*)naccept;
  float* beta_ = (float*)beta;
  const int32_t* seq_ = (const int32_t*)seq;
  const int64_t* seed_ = (const int64_t*)seed;
  const double* mu_ = (const double*)mu;
  const int32_t* ncode_ = (const int32_t*)ncode;
  const double* ew_c_ = (const double*)ew_c;
  if (!window) {
    kernel<<<blocks, walkers_per_block * lanes, smem, (cudaStream_t)stream>>>(
        occ_, enthalpy_, naccept_, beta_, seq_, seq_stride, seed_, t, mu_, ncode_, ew_c_,
        R, C, W, block_size, n_steps, rng_mode, lanes, walkers_per_block, resident, win);
    return (int)cudaGetLastError();
  }
  void* args[] = {&occ_, &enthalpy_, &naccept_, &beta_, &seq_, &seq_stride, &seed_,
                  const_cast<Tables*>(&t), &mu_, &ncode_, &ew_c_, &R, &C, &W, &block_size, &n_steps,
                  &rng_mode, &lanes, &walkers_per_block, &resident, const_cast<Window*>(&win)};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(blocks), dim3(walkers_per_block * lanes), args, smem,
      (cudaStream_t)stream);
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

Tables tables_of(const void* nbr, const void* stride, const void* d2, const void* g,
                 const void* ew_v, const void* qnbr, const void* qfreq, const void* qms,
                 const void* qac, const void* qas, const void* qrows, const void* imask,
                 const void* iamp, const void* irows, int R, int L, int K, int TM,
                 int Lq, int NB, int Li, int NW) {
  return Tables{(const int32_t*)nbr, (const int32_t*)stride, (const int32_t*)d2,
                (const double*)g, (const double*)ew_v, (const int32_t*)qnbr,
                (const int32_t*)qfreq, (const int32_t*)qms, (const double*)qac,
                (const double*)qas, (const int32_t*)qrows, L, K, TM,
                ew_v != nullptr ? R : 0, Lq, NB, (const uint64_t*)imask,
                (const double*)iamp, (const int32_t*)irows, Li, NW};
}

}  // namespace

extern "C" int smol_flip_chain(void* occ, void* enthalpy, void* naccept,
                               void* beta, const void* seq,
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
                               int Lq, int NB, int Li, int NW, int lanes,
                               int walkers_per_block, int resident, void* stream) {
  const Tables t = tables_of(nbr, stride, d2, g, ew_v, qnbr, qfreq, qms, qac, qas, qrows,
                             imask, iamp, irows, R, L, K, TM, Lq, NB, Li, NW);
  return launch(false, occ, enthalpy, naccept, beta, seq, seq_stride, seed, t, mu, ncode,
                ew_c, R, C, W, block_size, n_steps, rng_mode, q, lanes, walkers_per_block,
                resident, Window{}, stream);
}

// A tempering window: smol_flip_chain's operands (beta the f32 copy the
// Metropolis test reads, exchanged too), then the f64 betas, the snapshot
// buffer [2][2][W] f64, the uniforms [n_segments, W] f64, the exchange
// counts (or null), the elements from one segment's sequence rows to the
// next, the segments and the first exchange's phase.
extern "C" int smol_flip_window(void* occ, void* enthalpy, void* naccept,
                                void* beta, const void* seq,
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
                                int Lq, int NB, int Li, int NW, int lanes,
                                int walkers_per_block, int resident, void* beta64,
                                void* snap, const void* uniforms, void* accepted,
                                int64_t seq_segment, int n_segments, int phase0,
                                void* stream) {
  if (n_segments < 1 || beta64 == nullptr || snap == nullptr || uniforms == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Tables t = tables_of(nbr, stride, d2, g, ew_v, qnbr, qfreq, qms, qac, qas, qrows,
                             imask, iamp, irows, R, L, K, TM, Lq, NB, Li, NW);
  const Window win{(double*)beta64, (double*)snap, (const double*)uniforms,
                   (int32_t*)accepted, seq_segment, n_segments, phase0 & 1};
  return launch(true, occ, enthalpy, naccept, beta, seq, seq_stride, seed, t, mu, ncode,
                ew_c, R, C, W, block_size, n_steps, rng_mode, q, lanes, walkers_per_block,
                resident, win, stream);
}

// Blocks of the window's kernel for (q, NW, ewald, K, NB) that one SM holds
// at once with `threads` threads and `smem` bytes of dynamic shared memory
// a block (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.
extern "C" int smol_flip_window_blocks_per_sm(int q, int NW, int ewald, int K, int NB,
                                              int threads, int smem, int* out) {
  const Kernel kernel = pick_kernel<true>(q, NW, ewald != 0, K, NB);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, (size_t)smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, (size_t)smem);
  }
  return (int)err;
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

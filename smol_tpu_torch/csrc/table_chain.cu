// Shared-proposal table-move Metropolis chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU chain kernel of smol_tpu/ops/pallas_chain.py
// (make_shared_proposal_chain, move="table": `table_step` :1701-1785 with
// its site delta, the Ewald term ewald_delta (K4), the chemical work
// mu_work and the accept), the constrained-composition moves of a TableFlip
// usher, e.g. charge-neutral semigrand sampling where Li+ enters or leaves
// only together with Mn4+ <-> Mn3+.  It keeps flip_chain.cu's frame (lanes,
// the block's codes in shared memory for the whole window, Philox or the
// reference's hash):
//
// - Each step takes a direction row d of the move table and KM slot ranks,
//   both exogenous and shared by the walkers of a group.  The table's rows
//   hold, per slot, a from-code (-1: no check), a to-code (-2: the partner
//   slot's code, the swap row) and whether the slot is valid.
// - The codes a0[j] of all slots are read before the move.  The move is
//   valid if the row has a valid slot, every checked slot holds its
//   from-code and, on the swap row, a0[0] != a0[1].  An invalid move is an
//   identity proposal: nothing is computed, nothing accepted.
// - A valid move recolors its valid slots in order.  Slot j's delta is
//   taken against the occupancy as slots 0 .. j-1 left it: its site body's
//   terms (the direct lookup's clusters in order l = 0, 1, ...; K3's
//   character rows or K1-Ising's parity rows in row order, as the
//   reference's `table_step` calls the system's site delta, :1754), then
//   its Ewald term (b_j - a0[j]) * (C_r + V_r . occ), then minus its
//   chemical work mu[r, b_j] - mu[r, a0[j]]; then b_j is written into the
//   slot's shared cell, and into the walker's rank bits of the Ising body.
//   All in native f64 and in that order, as the plain torch twin in
//   ops/chain.py sums (the reference adds double-float f32 pairs and takes
//   the Ewald dot in f32).  Slots that are not valid contribute exactly
//   zero in the reference and are skipped here; only valid slots' sites
//   are known to be distinct.
// - Plain Metropolis on -beta * dH with the f32 exponent and the step's one
//   uniform (slot 1 of the hash, word x of Philox): the proposal is
//   symmetric, so no a-priori factor.  On reject the slots take a0 back.
//
// Lanes.  A walker is G consecutive threads of one warp (G = 1, 2, 4, 8 or
// 16, `lanes`; ops/chain.py launch_plan picks it from the launch's walkers
// and the site body), and a block holds `walkers_per_block` walkers of one
// sequence group (at most 256 threads), their codes in shared memory
// [R][code_pitch].  For each valid slot in order, lane j takes rows j,
// j + G, ... of the slot's rank (the direct and K3 rows in batches of
// kRowBatch, from the running dE on lane 0 and from +0.0 on the others;
// K1-Ising's parity sum in batches of kLaneBatch from +0.0, scaled after
// the lanes meet and added to dE), the partials meeting in a butterfly of
// __shfl_xor_sync; then the Ewald term, split over the lanes in the same
// way (in rank order on every lane it ran 1.19-1.96x slower on an H100,
// PERF.md), and the chemical work; then lane 0 writes b_j into the slot's cell between two
// __syncwarp, and every lane sets b_j in its own copy of the Ising bits,
// so that slot j + 1 sees slot j applied.  The step's uniform is drawn G
// steps at a time, one step a lane, and read with a shuffle, as in
// flip_chain.cu; the direction and the slot ranks are read each step.
// Every lane takes the decision and keeps its own enthalpy; lane 0 alone
// writes codes.  At G = 1 the rows are summed in row order onto the
// running dE, and the dot in rank order, as the one-thread kernel did.
// The frame (the walker's lanes, the codes' load and store, the split
// draw) is chain_common.cuh's LaneFrame.
//
// Rows.  Where every rank's rows of the body fit in shared memory beside
// the codes, the launch runs at least a step a rank and the rows add no
// wave of blocks over the SMs (`resident`, ops/chain.py launch_plan; the
// K1-Ising rows of the spinel CE + Ewald sgc 2x2x2 on a 100-step window),
// the block copies them once with cp.async and runs every step with no
// block barrier.  Otherwise the rows of the next step's valid
// slots are streamed into a second buffer of KM row sets with cp.async
// while this step runs (K8), behind one block barrier a step.
//
// What bounds it on this card: each walker's dependent step, not the
// roofline.  A valid move does the work of one flip per valid slot; most
// proposals of a charge-neutral system are identities (the drawn sites
// rarely hold the from-codes), and a warp is as slow as its slowest
// walker: at one thread a walker almost every warp of 32 walkers paid for
// a valid move.  With G lanes a warp holds 32 / G walkers, the rows of a
// slot are divided by G, and the per-step waits go where the rows are
// resident; what every lane repeats (the slots' codes and validity, the
// decision, the shuffles) stays.
//
// KMT is the slot count as a compile-time constant: 2 for one flip vector
// of two recolorings plus the swap row (the spinel), 0 for a runtime count
// up to 8, as KT is for the clusters' slot count K of the direct body.
//
// The occupancy ([R, W] int8 codes, rank-major), enthalpy and accept counts
// are updated in place.  The C entry point returns cudaGetLastError() after
// the launch.

#include "chain_common.cuh"

namespace {

using namespace smol;

constexpr int kMaxTableSlots = 8;
constexpr int kTableThreads = 256;  // most threads of a block: walkers x lanes
constexpr int kRowBatch = 4;  // direct and K3 rows a lane loads before it adds them

// Dynamic shared memory of one launch: the rows (every rank's, or two
// buffers of KM row sets) and the block's codes.
size_t shared_bytes(size_t rb, int R, int KM, int walkers_per_block, int resident) {
  return (resident ? (size_t)R : 2 * (size_t)KM) * rb +
         align16((size_t)R * code_pitch(walkers_per_block));
}

// Body: Direct<KT>, Qary<Q, NBT> or Ising<NW>, as in flip_chain.cu;
// KMT: the table move's slot count (0: runtime, at most kMaxTableSlots);
// EW: the tables carry the Ewald fold (ew_v [R, R], ew_c [R]).
template <class Body, int KMT, bool EW>
__global__ void __launch_bounds__(kTableThreads)
table_chain_kernel(int8_t* __restrict__ occ, double* __restrict__ enthalpy,
                   int32_t* __restrict__ naccept,
                   const float* __restrict__ beta,
                   const int32_t* __restrict__ dirs,
                   const int32_t* __restrict__ ranks, int dir_stride,
                   int rank_stride, const int64_t* __restrict__ seed_ptr,
                   const int32_t* __restrict__ nbr,
                   const int32_t* __restrict__ stride,
                   const int32_t* __restrict__ d2,
                   const double* __restrict__ g,
                   const double* __restrict__ mu,
                   const int32_t* __restrict__ move_rows,
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
                   int TM, int C, int Lq, int NB, int Li, int NW, int W,
                   int block_size, int n_steps, int rng_mode, int km_rt,
                   int n_rows, int lanes, int walkers_per_block, int resident) {
  using Ln = Lanes<Body>;
  // the tables with their compile-time counts, as swap_chain.cu takes them
  Tables t{nbr, stride, d2, g, ew_v, qnbr, qfreq, qms, qac, qas, qrows,
           L, K, TM, EW ? R : 0, Lq, NB, imask, iamp, irows, Li, NW};
  Body::pin(t);
  const int KM = KMT > 0 ? KMT : km_rt;
  constexpr int kSlots = KMT > 0 ? KMT : kMaxTableSlots;
  const LaneFrame f(lanes, walkers_per_block, W);
  const int tid = f.tid, nt = f.nt, lane = f.lane, pitch = f.pitch;
  const unsigned mask = f.mask;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = Body::bytes(t);
  int8_t* s_occ =
      reinterpret_cast<int8_t*>(smem + (resident ? (size_t)R : 2 * (size_t)KM) * rb);

  // the move table [3, n_rows, KM]: from-code, to-code, slot valid
  const int32_t* from_code = move_rows;
  const int32_t* to_code = move_rows + n_rows * KM;
  const int32_t* slot_valid = move_rows + 2 * n_rows * KM;

  f.load_codes(s_occ, occ, R);
  int8_t* codes = s_occ + f.wl;  // the walker's column of the codes

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = f.w0 / block_size;
  const int32_t* my_dirs = dirs + (size_t)grp * dir_stride;
  const int32_t* my_ranks = ranks + (size_t)grp * rank_stride;
  const Draws draws(*seed_ptr, grp, f.wc, block_size);

  auto prefetch = [&](int i) {  // step i's valid slots' rows into buffer i & 1
    unsigned char* buf = smem + (i & 1) * KM * rb;
    const int d = __ldg(my_dirs + i);
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (__ldg(slot_valid + d * KM + j) > 0) {
        Body::copy(buf + j * rb, __ldg(my_ranks + (size_t)i * KM + j), t, tid, nt);
      }
    }
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

  float my_logu = 0.0f;  // log U, drawn G steps at a time (lane_log_u)
  for (int i = 0; i < n_steps; ++i) {
    if (!resident && i + 1 < n_steps) prefetch(i + 1);
    // a dead walker's lanes only copy rows and meet the block's barrier
    if (f.live) {
      const float log_u = lane_log_u(my_logu, draws, i, n_steps, rng_mode, f);
      const int d = __ldg(my_dirs + i);
      const int32_t* fc = from_code + d * KM;
      const int32_t* tc = to_code + d * KM;
      const int32_t* sv = slot_valid + d * KM;
      const int32_t* rk = my_ranks + (size_t)i * KM;

      // every slot's code before the move, and the move's validity
      int a0[kSlots] = {};
      bool valid = __ldg(sv) > 0;  // the null row has no valid slot
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        a0[j] = codes[__ldg(rk + j) * pitch];
        const int from = __ldg(fc + j);
        const bool need = __ldg(sv + j) > 0 && from >= 0;
        valid = valid && (!need || a0[j] == from);
      }
      if (__ldg(tc) == -2) valid = valid && a0[0] != a0[1];  // the swap row

      if (valid) {
        unsigned char* buf = smem + (size_t)(i & 1) * KM * rb;
        double dE = 0.0;
        typename Body::Walker wv = wk;  // the walker as the earlier slots left it
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (__ldg(sv + j) > 0) {
            const int r = __ldg(rk + j);
            const int to = __ldg(tc + j);
            const int a = a0[j];
            const int b = to >= 0 ? to : a0[j ^ 1];  // -2: the partner's code
            const typename Body::Rows rows =
                Body::at(resident ? smem + (size_t)r * rb : buf + j * rb, t);
            // the Ewald term is taken first and added after the cluster
            // terms: the same sum in the same order, but with the dot issued
            // first a one-thread window ran a fifth faster on an H100
            double ewald = 0.0;
            if constexpr (EW) {
              ewald = lane_ewald_term(rows.ew, __ldg(ew_c + r), codes, pitch, R, b - a, lane,
                                      lanes, mask);
            }
            if constexpr (Ln::kScaled) {
              const double s = lane_sum(Ln::sum(rows, t, r, wv, lane, lanes), mask, lanes);
              dE = dE + (double)(-2 * (b - a)) * s;
            } else {
              // lane 0 carries the running dE, so one lane adds the rows onto it
              dE = lane_sum(Ln::template add<kRowBatch>(lane == 0 ? dE : 0.0, rows, t, r, codes,
                                                        pitch, a, b, wv, lane, lanes),
                            mask, lanes);
            }
            if constexpr (EW) dE += ewald;
            const double work = __ldg(mu + r * C + b) - __ldg(mu + r * C + a);
            dE -= work;
            __syncwarp(mask);  // every lane has read the codes
            if (lane == 0) codes[r * pitch] = (int8_t)b;  // the next slot sees this one applied
            wv.set(r, b);
            __syncwarp(mask);
          }
        }
        // the Metropolis decision in f32, as metropolis() takes it
        const float expo = -b32 * (float)dE;
        if (expo >= 0.0f || expo > log_u) {
          e += dE;
          ++nacc;
          wk = wv;
        } else if (lane == 0) {
#pragma unroll
          for (int j = 0; j < KM; ++j) {
            if (__ldg(sv + j) > 0) codes[__ldg(rk + j) * pitch] = (int8_t)a0[j];
          }
        }
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
  }
}

using Kernel = decltype(&table_chain_kernel<Direct<3>, 2, false>);

// The site body of a launch for a slot count KMT, as flip_chain.cu picks it.
template <int KMT>
Kernel pick_body(int q, int nw, bool ew, int K, int NB) {
  switch (nw) {
    case 0: break;
    case 1: return ew ? table_chain_kernel<Ising<1>, KMT, true> : table_chain_kernel<Ising<1>, KMT, false>;
    case 2: return ew ? table_chain_kernel<Ising<2>, KMT, true> : table_chain_kernel<Ising<2>, KMT, false>;
    case 3: return ew ? table_chain_kernel<Ising<3>, KMT, true> : table_chain_kernel<Ising<3>, KMT, false>;
    case 4: return ew ? table_chain_kernel<Ising<4>, KMT, true> : table_chain_kernel<Ising<4>, KMT, false>;
    default: return nullptr;
  }
  if (q == 0) {
    return ew ? (K == 3 ? table_chain_kernel<Direct<3>, KMT, true> : table_chain_kernel<Direct<0>, KMT, true>)
              : (K == 3 ? table_chain_kernel<Direct<3>, KMT, false> : table_chain_kernel<Direct<0>, KMT, false>);
  }
  if (q == 2) {  // an Ewald term needs binary sites: q = 2 only
    return ew ? (NB == 2 ? table_chain_kernel<Qary<2, 2>, KMT, true> : table_chain_kernel<Qary<2, 0>, KMT, true>)
              : (NB == 2 ? table_chain_kernel<Qary<2, 2>, KMT, false> : table_chain_kernel<Qary<2, 0>, KMT, false>);
  }
  if (ew) return nullptr;
  if (q == 3) return NB == 2 ? table_chain_kernel<Qary<3, 2>, KMT, false> : table_chain_kernel<Qary<3, 0>, KMT, false>;
  if (q == 4) return NB == 2 ? table_chain_kernel<Qary<4, 2>, KMT, false> : table_chain_kernel<Qary<4, 0>, KMT, false>;
  return nullptr;
}

}  // namespace

extern "C" int smol_table_chain(void* occ, void* enthalpy, void* naccept,
                                const void* beta, const void* dirs,
                                const void* ranks, int dir_stride,
                                int rank_stride, const void* seed,
                                const void* nbr, const void* stride,
                                const void* d2, const void* g, const void* mu,
                                const void* move_rows, const void* ew_v,
                                const void* ew_c, const void* qnbr,
                                const void* qfreq, const void* qms,
                                const void* qac, const void* qas,
                                const void* qrows, const void* imask,
                                const void* iamp, const void* irows, int R,
                                int L, int K, int TM, int C, int W,
                                int block_size, int n_steps, int rng_mode,
                                int k_max, int n_rows, int q, int Lq, int NB,
                                int Li, int NW, int lanes, int walkers_per_block,
                                int resident, void* stream) {
  if (k_max < 2 || k_max > kMaxTableSlots ||
      !lane_launch_ok(W, lanes, walkers_per_block, block_size, kTableThreads, resident)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool ew = ew_v != nullptr;
  const Tables t{(const int32_t*)nbr, (const int32_t*)stride, (const int32_t*)d2,
                 (const double*)g, (const double*)ew_v, (const int32_t*)qnbr,
                 (const int32_t*)qfreq, (const int32_t*)qms, (const double*)qac,
                 (const double*)qas, (const int32_t*)qrows, L, K, TM, ew ? R : 0, Lq,
                 NB, (const uint64_t*)imask, (const double*)iamp,
                 (const int32_t*)irows, Li, NW};
  const Kernel kernel = k_max == 2 ? pick_body<2>(q, NW, ew, K, NB)
                                   : pick_body<0>(q, NW, ew, K, NB);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t rb = NW > 0   ? Ising<1>::bytes(t)
                    : q == 0 ? Direct<0>::bytes(t)
                             : Qary<2, 0>::bytes(t);
  const size_t smem = shared_bytes(rb, R, k_max, walkers_per_block, resident);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (W + walkers_per_block - 1) / walkers_per_block;
  kernel<<<blocks, walkers_per_block * lanes, smem, (cudaStream_t)stream>>>(
      (int8_t*)occ, (double*)enthalpy, (int32_t*)naccept, (const float*)beta,
      (const int32_t*)dirs, (const int32_t*)ranks, dir_stride, rank_stride,
      (const int64_t*)seed, t.nbr, t.stride, t.d2, t.g, (const double*)mu,
      (const int32_t*)move_rows, t.ew_v, (const double*)ew_c, t.qnbr, t.qfreq,
      t.qms, t.qac, t.qas, t.qrows, t.imask, t.iamp, t.irows, R, L, K, TM, C,
      Lq, NB, Li, NW, W, block_size, n_steps, rng_mode, k_max, n_rows, lanes,
      walkers_per_block, resident);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

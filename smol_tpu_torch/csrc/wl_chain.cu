// Shared-proposal Wang-Landau chain (flips or swaps) for NVIDIA Hopper (sm_90a).
//
// Replaces the Wang-Landau branch of the TPU chain kernel of
// smol_tpu/ops/pallas_chain.py (make_shared_proposal_chain with
// wl=WLChain: the accept :1866-1880, the bookkeeping and flatness check
// :1899-1973, the initial carry :1978-1986), for move="flip" and
// move="swap".  The deltas are those of flip_chain.cu and swap_chain.cu
// (cluster terms, Ewald term, chemical work of a flip), summed in f64 in
// the order of the plain torch twin in ops/chain.py (wl_chain_reference).
// The site body is a template parameter: the direct lookup, K3's q-ary
// character rows or K1-Ising's parity rows; the reference takes the body
// of the system in its Wang-Landau branches too (:1827, :1850).
//
// Per step: E' = E + dE, w' = E' - min_enthalpy, b' = clip(floor(w' /
// bin_size), 0, B - 1).  The proposal is rejected if w' lies outside
// [0, span), else accepted if x = S[b_cur] - S[b'] >= 0 or x > log U, with
// x taken in f32 like the Metropolis exponent (a null swap is never
// accepted).  Then, at the current state: inside the window the walker's
// counter gains one, and on every update_period-th count S[b_cur] +=
// mod_factor and the histogram and occurrences at b_cur gain one.  When
// (i + 1) % check_period == 0, i the step of this launch, and at the
// launch's last step, the walker's histogram is tested for flatness over
// the bins with S > 0: at least two visited and min > flatness * mean (the
// integer sum and minimum exact, the compare in f32 as the reference's);
// a flat histogram is zeroed and mod_factor divided by mod_divisor.
// Enthalpy, window coordinate, entropy and mod_factor are native f64: the
// reference's double-float entropy pair, its f32 binning, its one-hot bin
// selects and row write-backs and its cap on the walker block exist for
// the TPU's vector unit and VMEM and are not carried over.
//
// Lanes.  A walker is G consecutive threads of one warp (G = 1, 2, 4, 8 or
// 16, `lanes`; ops/chain.py wl_lanes takes the fewest that give the launch
// 32768 threads), and a block holds `walkers_per_block` walkers of
// one sequence group, its codes in shared memory indexed by walker.  Lane j
// takes rows j, j + G, j + 2G, ... of each rank's rows in row order from
// +0.0 (the Ising body in batches of kLaneBatch rows whose loads are all
// issued first); the G partials meet in a
// butterfly of __shfl_xor_sync (xor 1, 2, 4, ...), after which every lane
// holds the same dE bits.  A swap sums u's rows then v's into one partial
// (direct, K3) or butterflies u's and v's parity sums apart (K1-Ising,
// whose sum is scaled per rank).  The Ewald dot stays in rank order on
// every lane.  Every lane then draws, bins, reads S[b'] and decides for
// itself, so each holds the walker's state (enthalpy, bin, S[b_cur],
// mod_factor, counter and, for K1-Ising, the rank bits) in registers.
// Lane 0 alone writes the walker's codes and plane cells; __syncwarp over
// the walker's lanes orders the write of b into u's cell before v's rows,
// every lane's reads before the decision's writes, and those writes before
// the next step.  The flatness pass is split over the lanes (lane j takes
// bins j, j + G, ...; the visited count, the integer sum and the minimum
// meet by shuffles, exactly), and so is the histogram's zeroing.  At G = 1
// the same code sums the rows in row order, as the one-thread kernels did
// (lane_flip_delta, lane_swap_delta in chain_common.cuh).
//
// Rows.  Where every rank's rows of the body fit in shared memory beside
// the block's codes (`resident`; the launcher's budget decides from the
// shapes: the Ising rows of Au-Cu 3x3x3, 50 KB, and 4x4x4, 118 KB), the
// block copies them once with cp.async and runs every step with no block
// barrier.  Otherwise (the direct rows, 11 KB a rank) the next step's rows
// of u (and v) are streamed into a second buffer with cp.async while this
// step runs (K8), behind one block barrier a step.
//
// Planes.  The entropy (f64), histogram and occurrences (int32) are [B, W]
// in global memory, bin-major.  With `planes` = 1 the block keeps the
// entropy in shared memory for the whole launch ([walker][B | 1]: a
// walker's bins contiguous for the split flatness pass, the odd pitch
// putting the walkers' rows in different banks), loaded at its start and
// written back at its end; the launcher takes it wherever it fits beside
// the rows and codes (ops/chain.py wl_launch_plan).  Every access is the
// walker's own, so a step reads what its earlier steps wrote.  With the
// entropy in shared memory the histogram and occurrences gain their count
// by a fire-and-forget atomicAdd (nothing waits on an L2 round trip) and
// are read only by the flatness pass; with all three global (`planes` =
// 0) the walker's histogram cells at its current bin ride in registers and
// the proposed bin's are loaded with S[b'], used only on accept.
//
// What bounds it on this card: not the roofline (chip_smoke.py wl_bound:
// the operands, and of the planes what the launch's data needs, read and
// written once, and the delta's f64 operations; the kernel stays tens of
// times above it on an H100, PERF.md), but each walker's dependent step.
// At one thread a walker that was the rows a thread walks in turn, on 32
// of 132 SMs for bench wang-landau's 2048 walkers, and the per-step waits
// (the cp.async wait and block barrier, S[b'] from L2).  The lanes divide
// the rows by G and put G times more warps on the card, resident rows drop
// the wait and the barrier, a resident entropy the L2 round trip.  What is
// left is the step's fixed chain that every lane repeats (the draws, the
// binning division, the decision, the shuffles): 8192 walkers at 4 lanes
// take only about 1.6x as long as 2048 at 16, so the step's latency, not
// the issue rate, bounds it.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <climits>

#include "chain_common.cuh"

namespace {

using namespace smol;

constexpr int kFlip = 0;
constexpr int kSwap = 1;
constexpr int kWLThreads = 256;  // most threads of a block: walkers x lanes

struct WLParams {
  int num_levels;     // B
  int check_period;
  int update_period;
  double min_enthalpy;
  double bin_size;
  double span;        // B * bin_size
  double mod_divisor;
  float flatness;
};

__device__ __forceinline__ int wl_bin(double w, double bin_size, int B) {
  const double q = floor(w / bin_size);
  return q < 0.0 ? 0 : (q > (double)(B - 1) ? B - 1 : (int)q);
}

// The block's entropy in shared memory: [walkers_per_block][plane_pitch(B)].
__host__ __device__ __forceinline__ int plane_pitch(int B) { return B | 1; }

__host__ __device__ __forceinline__ size_t planes_bytes(int B, int walkers_per_block,
                                                        int planes) {
  return planes ? align16((size_t)plane_pitch(B) * walkers_per_block * 8) : 0;
}

// Dynamic shared memory of one launch: the rows (every rank's, or two
// buffers of the step's row sets), the planes, the codes.
size_t shared_bytes(size_t rb, int R, int row_sets, int B, int walkers_per_block,
                    int resident, int planes) {
  return (resident ? (size_t)R : 2 * (size_t)row_sets) * rb +
         planes_bytes(B, walkers_per_block, planes) +
         align16((size_t)R * code_pitch(walkers_per_block));
}

// MOVE: kFlip or kSwap; Body: Direct<KT>, Qary<Q, NBT> or Ising<NW>, as in
// flip_chain.cu; EW: the tables carry the Ewald fold.
template <int MOVE, class Body, bool EW>
__global__ void __launch_bounds__(kWLThreads)
wl_chain_kernel(int8_t* __restrict__ occ, double* __restrict__ enthalpy,
                int32_t* __restrict__ naccept, double* __restrict__ entropy,
                int32_t* __restrict__ hist, int32_t* __restrict__ occr,
                double* __restrict__ mod_factor,
                int32_t* __restrict__ wl_counter,
                const int32_t* __restrict__ useq,
                const int32_t* __restrict__ vseq, int seq_stride,
                const int64_t* __restrict__ seed_ptr,
                const int32_t* __restrict__ nbr,
                const int32_t* __restrict__ stride,
                const int32_t* __restrict__ d2,
                const double* __restrict__ g,
                const double* __restrict__ mu,
                const int32_t* __restrict__ ncode,
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
                int block_size, int n_steps, int rng_mode, WLParams p, int lanes,
                int walkers_per_block, int resident, int planes) {
  // the tables with their compile-time counts, as swap_chain.cu takes them
  Tables t{nbr, stride, d2, g, ew_v, qnbr, qfreq, qms, qac, qas, qrows,
           L, K, TM, EW ? R : 0, Lq, NB, imask, iamp, irows, Li, NW};
  Body::pin(t);
  constexpr int NR = MOVE == kSwap ? 2 : 1;  // row sets of one step
  const int B = p.num_levels;
  const LaneFrame f(lanes, walkers_per_block, W);
  const int tid = f.tid, nt = f.nt, lane = f.lane, pitch = f.pitch;
  const int wpb = f.wpb, wl = f.wl, w0 = f.w0, wc = f.wc;
  const bool live = f.live;
  const unsigned mask = f.mask;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = Body::bytes(t);
  unsigned char* s_planes = smem + (resident ? (size_t)R : 2 * (size_t)NR) * rb;
  const int bp = plane_pitch(B);
  double* s_ent = reinterpret_cast<double*>(s_planes);
  int8_t* s_occ = reinterpret_cast<int8_t*>(s_planes + planes_bytes(B, wpb, planes));

  f.load_codes(s_occ, occ, R);
  for (int x = tid; x < B * wpb && planes; x += nt) {  // bin-major reads
    const int bin = x / wpb;
    const int c = x % wpb;
    if (w0 + c < W) s_ent[c * bp + bin] = entropy[(size_t)bin * W + w0 + c];
  }
  // the walker's cells of each plane: cell `bin` at bin * stride
  double* ent = planes ? s_ent + wl * bp : entropy + wc;
  const size_t es = planes ? 1 : (size_t)W;
  int32_t* hst = hist + wc;
  int32_t* ocr = occr + wc;
  const size_t hs = W;
  const bool carry = !planes;  // histogram cells ride in registers
  int8_t* codes = s_occ + wl;      // the walker's column of the codes

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = w0 / block_size;
  const int32_t* my_useq = useq + (size_t)grp * seq_stride;
  const int32_t* my_vseq = vseq + (size_t)grp * seq_stride;
  const Draws draws(*seed_ptr, grp, wc, block_size);

  auto prefetch = [&](int i) {  // step i's rows into slot i & 1
    unsigned char* slot = smem + (i & 1) * NR * rb;
    Body::copy(slot, __ldg(my_useq + i), t, tid, nt);
    if (MOVE == kSwap) Body::copy(slot + rb, __ldg(my_vseq + i), t, tid, nt);
  };
  if (resident) {
    for (int r = 0; r < R; ++r) Body::copy(smem + r * rb, r, t, tid, nt);
  } else if (n_steps > 0) {
    prefetch(0);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  typename Body::Walker wk;  // the Ising body's rank bits; nothing otherwise
  wk.load(s_occ, R, pitch, wl);
  double e = enthalpy[wc];
  double modf = mod_factor[wc];
  int cnt = wl_counter[wc];
  int nacc = 0;

  // the initial carry: the current window coordinate and bin, and the
  // walker's own cells of the planes at that bin
  double w_cur = e - p.min_enthalpy;
  int bin_cur = wl_bin(w_cur, p.bin_size, B);
  double s_cur = live ? ent[bin_cur * es] : 0.0;
  int h_cur = live && carry ? hst[bin_cur * hs] : 0;
  int o_cur = live && carry ? ocr[bin_cur * hs] : 0;

  for (int i = 0; i < n_steps; ++i) {
    unsigned char* slot = smem + (i & 1) * NR * rb;
    if (!resident && i + 1 < n_steps) prefetch(i + 1);

    // a dead walker's lanes only copy rows and meet the block's barrier
    if (live) {
      const int u = __ldg(my_useq + i);
      const typename Body::Rows ru = Body::at(resident ? smem + u * rb : slot, t);
      int8_t* cu = codes + u * pitch;
      const int a = *cu;
      const uint2 bits = draws.at(i, rng_mode);  // (r_u, r_j)
      int b;
      int8_t* cv = cu;
      int v = u;
      bool is_move = true;
      double dE;
      if (MOVE == kSwap) {
        v = __ldg(my_vseq + i);
        const typename Body::Rows rv =
            Body::at(resident ? smem + v * rb : slot + rb, t);
        cv = codes + v * pitch;
        b = *cv;
        is_move = a != b;
        dE = lane_swap_delta<Body, EW>(ru, rv, t, u, v, cu, a, b, codes, pitch, R, ew_c, wk,
                                       lane, lanes, mask);
      } else {
        const int nc = max(__ldg(ncode + u) - 1, 1);
        const int j = (int)(bits.y % (uint32_t)nc);
        b = j + (j >= a ? 1 : 0);
        dE = lane_flip_delta<Body, EW>(ru, t, u, a, b, codes, pitch, R, C, mu, ew_c, wk,
                                       lane, lanes, mask);
      }

      // the Wang-Landau rule on the proposed bin
      const double e_new = e + dE;
      const double w_new = e_new - p.min_enthalpy;
      const int bin_new = wl_bin(w_new, p.bin_size, B);
      const bool in_win = w_new >= 0.0 && w_new < p.span;
      const double s_new = ent[bin_new * es];
      // used on accept only; loaded here so that they share S[b']'s round trip
      const int h_new = carry ? hst[bin_new * hs] : 0;
      const int o_new = carry ? ocr[bin_new * hs] : 0;
      __syncwarp(mask);  // every lane has read the codes
      if (in_win && is_move && accept_exponent((float)(s_cur - s_new), bits.x)) {
        if (lane == 0) {
          if (MOVE == kSwap) {
            *cv = (int8_t)a;
          } else {
            *cu = (int8_t)b;
          }
        }
        if (MOVE == kSwap) wk.set(v, a);
        wk.set(u, b);
        e = e_new;
        w_cur = w_new;
        bin_cur = bin_new;
        s_cur = s_new;
        h_cur = h_new;
        o_cur = o_new;
        ++nacc;
      } else if (MOVE == kSwap && lane == 0) {
        *cu = (int8_t)a;
      }

      // the bookkeeping at the (possibly new) current state
      if (w_cur >= 0.0 && w_cur < p.span) {
        ++cnt;
        if (cnt % p.update_period == 0) {
          s_cur += modf;
          ++h_cur;
          ++o_cur;
          if (lane == 0) {
            ent[bin_cur * es] = s_cur;
            if (carry) {
              hst[bin_cur * hs] = h_cur;
              ocr[bin_cur * hs] = o_cur;
            } else {
              atomicAdd(hst + bin_cur * hs, 1);
              atomicAdd(ocr + bin_cur * hs, 1);
            }
          }
        }
      }

      // the flatness check, on this launch's step count, over the lanes
      if ((i + 1) % p.check_period == 0 || i + 1 == n_steps) {
        __syncwarp(mask);  // lane 0's writes, before the pass
        int nvis = 0;
        int hmin = INT_MAX;
        long long hsum = 0;
#pragma unroll 4
        for (int bin = lane; bin < B; bin += lanes) {
          const double s = ent[bin * es];
          const int h = hst[bin * hs];
          if (s > 0.0) {
            ++nvis;
            hsum += h;
            hmin = min(hmin, h);
          }
        }
        for (int m = 1; m < lanes; m <<= 1) {
          nvis += __shfl_xor_sync(mask, nvis, m);
          hsum += __shfl_xor_sync(mask, hsum, m);
          hmin = min(hmin, __shfl_xor_sync(mask, hmin, m));
        }
        const float hmean = (float)hsum / (float)max(nvis, 1);
        if (nvis >= 2 && (float)hmin > p.flatness * hmean) {
          for (int bin = lane; bin < B; bin += lanes) hst[bin * hs] = 0;
          h_cur = 0;
          modf /= p.mod_divisor;
        }
      }
      __syncwarp(mask);  // this step's writes, before the next
    }
    if (!resident) {
      __pipeline_wait_prior(0);
      __syncthreads();
    }
  }

  __syncthreads();
  f.store_codes(occ, s_occ, R);
  for (int x = tid; x < B * wpb && planes; x += nt) {
    const int bin = x / wpb;
    const int c = x % wpb;
    if (w0 + c < W) entropy[(size_t)bin * W + w0 + c] = s_ent[c * bp + bin];
  }
  if (live && lane == 0) {
    enthalpy[f.w] = e;
    naccept[f.w] += nacc;
    mod_factor[f.w] = modf;
    wl_counter[f.w] = cnt;
  }
}

using Kernel = decltype(&wl_chain_kernel<kFlip, Direct<3>, false>);

// The instantiation of a launch, as flip_chain.cu picks it, for each move.
template <int MOVE>
Kernel pick_kernel(int q, int nw, bool ew, int K, int NB) {
  switch (nw) {
    case 0: break;
    case 1: return ew ? wl_chain_kernel<MOVE, Ising<1>, true> : wl_chain_kernel<MOVE, Ising<1>, false>;
    case 2: return ew ? wl_chain_kernel<MOVE, Ising<2>, true> : wl_chain_kernel<MOVE, Ising<2>, false>;
    case 3: return ew ? wl_chain_kernel<MOVE, Ising<3>, true> : wl_chain_kernel<MOVE, Ising<3>, false>;
    case 4: return ew ? wl_chain_kernel<MOVE, Ising<4>, true> : wl_chain_kernel<MOVE, Ising<4>, false>;
    default: return nullptr;
  }
  if (q == 0) {
    return ew ? (K == 3 ? wl_chain_kernel<MOVE, Direct<3>, true> : wl_chain_kernel<MOVE, Direct<0>, true>)
              : (K == 3 ? wl_chain_kernel<MOVE, Direct<3>, false> : wl_chain_kernel<MOVE, Direct<0>, false>);
  }
  if (q == 2) {  // an Ewald term needs binary sites: q = 2 only
    return ew ? (NB == 2 ? wl_chain_kernel<MOVE, Qary<2, 2>, true> : wl_chain_kernel<MOVE, Qary<2, 0>, true>)
              : (NB == 2 ? wl_chain_kernel<MOVE, Qary<2, 2>, false> : wl_chain_kernel<MOVE, Qary<2, 0>, false>);
  }
  if (ew) return nullptr;
  if (q == 3) return NB == 2 ? wl_chain_kernel<MOVE, Qary<3, 2>, false> : wl_chain_kernel<MOVE, Qary<3, 0>, false>;
  if (q == 4) return NB == 2 ? wl_chain_kernel<MOVE, Qary<4, 2>, false> : wl_chain_kernel<MOVE, Qary<4, 0>, false>;
  return nullptr;
}

}  // namespace

extern "C" int smol_wl_chain(void* occ, void* enthalpy, void* naccept,
                             void* entropy, void* hist, void* occr,
                             void* mod_factor, void* wl_counter,
                             const void* useq, const void* vseq,
                             int seq_stride, const void* seed, const void* nbr,
                             const void* stride, const void* d2, const void* g,
                             const void* mu, const void* ncode,
                             const void* ew_v, const void* ew_c,
                             const void* qnbr, const void* qfreq,
                             const void* qms, const void* qac, const void* qas,
                             const void* qrows, const void* imask,
                             const void* iamp, const void* irows, int R, int L,
                             int K, int TM, int C, int W, int block_size,
                             int n_steps, int rng_mode, int move,
                             int num_levels, int check_period,
                             int update_period, int q, int Lq, int NB, int Li,
                             int NW, int lanes, int walkers_per_block,
                             int resident, int planes, double min_enthalpy,
                             double bin_size, double span, double mod_divisor,
                             float flatness, void* stream) {
  if ((move != kFlip && move != kSwap) || planes < 0 || planes > 1 ||
      !lane_launch_ok(W, lanes, walkers_per_block, block_size, kWLThreads, resident)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool ew = ew_v != nullptr;
  const Tables t{(const int32_t*)nbr, (const int32_t*)stride, (const int32_t*)d2,
                 (const double*)g, (const double*)ew_v, (const int32_t*)qnbr,
                 (const int32_t*)qfreq, (const int32_t*)qms, (const double*)qac,
                 (const double*)qas, (const int32_t*)qrows, L, K, TM, ew ? R : 0, Lq,
                 NB, (const uint64_t*)imask, (const double*)iamp,
                 (const int32_t*)irows, Li, NW};
  const Kernel kernel = move == kSwap ? pick_kernel<kSwap>(q, NW, ew, K, NB)
                                      : pick_kernel<kFlip>(q, NW, ew, K, NB);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t rb = NW > 0   ? Ising<1>::bytes(t)
                    : q == 0 ? Direct<0>::bytes(t)
                             : Qary<2, 0>::bytes(t);
  const size_t smem = shared_bytes(rb, R, move == kSwap ? 2 : 1, num_levels,
                                   walkers_per_block, resident, planes);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  WLParams p;
  p.num_levels = num_levels;
  p.check_period = check_period;
  p.update_period = update_period;
  p.min_enthalpy = min_enthalpy;
  p.bin_size = bin_size;
  p.span = span;
  p.mod_divisor = mod_divisor;
  p.flatness = flatness;
  const int blocks = (W + walkers_per_block - 1) / walkers_per_block;
  kernel<<<blocks, walkers_per_block * lanes, smem, (cudaStream_t)stream>>>(
      (int8_t*)occ, (double*)enthalpy, (int32_t*)naccept, (double*)entropy,
      (int32_t*)hist, (int32_t*)occr, (double*)mod_factor,
      (int32_t*)wl_counter, (const int32_t*)useq, (const int32_t*)vseq,
      seq_stride, (const int64_t*)seed, t.nbr, t.stride, t.d2, t.g,
      (const double*)mu, (const int32_t*)ncode, t.ew_v, (const double*)ew_c,
      t.qnbr, t.qfreq, t.qms, t.qac, t.qas, t.qrows, t.imask, t.iamp, t.irows,
      R, L, K, TM, C, Lq, NB, Li, NW, W, block_size, n_steps, rng_mode, p, lanes,
      walkers_per_block, resident, planes);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

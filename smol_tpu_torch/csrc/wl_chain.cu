// Shared-proposal Wang-Landau chain (flips or swaps) for NVIDIA Hopper (sm_90a).
//
// Replaces the Wang-Landau branch of the TPU chain kernel of
// smol_tpu/ops/pallas_chain.py (make_shared_proposal_chain with
// wl=WLChain: the accept :1866-1880, the bookkeeping and flatness check
// :1899-1973, the initial carry :1978-1986), for move="flip" and
// move="swap".  It keeps flip_chain.cu's frame: one thread per walker, the
// block's codes in shared memory for the whole launch, the next step's
// table rows (u's, and v's for a swap) prefetched with cp.async into two
// buffers, Philox or the reference's hash, and the deltas of flip_chain.cu
// and swap_chain.cu (flip_delta and swap_delta of chain_common.cuh: cluster
// terms, Ewald term, chemical work of a flip), summed in f64 in the same
// order as the plain torch twin in ops/chain.py.
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
// Where the planes live.  Entropy (f64), histogram and occurrences (int32)
// are [B, W], bin-major like the occupancy's [R, W]: 16 bytes per bin and
// walker, megabytes per launch, far above shared memory, so they stay in
// global memory and are served by L2.  Bin-major makes the flatness pass
// coalesced (the threads of a warp read neighbouring walkers of one bin)
// and lets walkers of a warp that sit in one bin share a sector; the
// state outside keeps the reference's [W, B] and is transposed once per
// window by the caller.  The walker's own cell of each plane at its current
// bin rides in registers (s_cur, h_cur, o_cur), so the only plane read on
// the step's critical path is the proposed bin's: S[b'], with the
// histogram and occurrences of b' loaded beside it in the same round trip
// and used only on accept.  The three updates are then plain stores that
// nothing waits for.  Every plane access is an ordinary load or store of
// the walker's own thread (no read-only cache path), so a step reads what
// the walker's earlier steps wrote.  Threads beyond the last walker take
// part in the block's barriers and row copies and never touch a plane.
//
// What bounds it on this card: as for the flip chain, the latency of each
// walker's dependent step; the Wang-Landau rule adds one L2 round trip
// (S[b']) between the delta and the decision.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <climits>

#include "chain_common.cuh"

namespace {

using namespace smol;

constexpr int kFlip = 0;
constexpr int kSwap = 1;

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

// MOVE: kFlip or kSwap; KT: the slot count K as a compile-time constant
// (0: runtime K); EW: the tables carry the Ewald fold.
template <int MOVE, int KT, bool EW>
__global__ void __launch_bounds__(kMaxThreads)
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
                const double* __restrict__ ew_c, int R, int L, int K_rt,
                int TM, int C, int W, int block_size, int n_steps,
                int rng_mode, WLParams p) {
  const int K = KT > 0 ? KT : K_rt;
  const int RE = EW ? R : 0;
  constexpr int NR = MOVE == kSwap ? 2 : 1;  // row sets of one step
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t rb = rows_bytes(L, K, TM, RE);
  int8_t* s_occ = reinterpret_cast<int8_t*>(smem + 2 * NR * rb);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int w = blockIdx.x * nt + tid;
  const bool live = w < W;
  const int wc = live ? w : W - 1;  // dead threads shadow the last walker

  for (int r = 0; r < R; ++r) {
    s_occ[r * nt + tid] = occ[(size_t)r * W + wc];
  }
  double e = enthalpy[wc];
  double modf = mod_factor[wc];
  int cnt = wl_counter[wc];
  int nacc = 0;
  const int B = p.num_levels;

  // the initial carry: the current window coordinate and bin, and the
  // walker's own cell of each plane at that bin
  double w_cur = e - p.min_enthalpy;
  size_t at = (size_t)wl_bin(w_cur, p.bin_size, B) * W + wc;
  double s_cur = live ? entropy[at] : 0.0;
  int h_cur = live ? hist[at] : 0;
  int o_cur = live ? occr[at] : 0;

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = (blockIdx.x * nt) / block_size;
  const int32_t* my_useq = useq + (size_t)grp * seq_stride;
  const int32_t* my_vseq = vseq + (size_t)grp * seq_stride;
  const Draws draws(*seed_ptr, grp, wc, block_size);

  auto prefetch = [&](int i) {  // step i's rows into slot i & 1
    unsigned char* slot = smem + (i & 1) * NR * rb;
    copy_rows(rows_at(slot, L, K, TM, RE), __ldg(my_useq + i), nbr, stride,
              d2, g, ew_v, L, K, TM, RE, tid, nt);
    if (MOVE == kSwap) {
      copy_rows(rows_at(slot + rb, L, K, TM, RE), __ldg(my_vseq + i), nbr,
                stride, d2, g, ew_v, L, K, TM, RE, tid, nt);
    }
  };
  if (n_steps > 0) prefetch(0);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    unsigned char* slot = smem + (i & 1) * NR * rb;
    const Rows ru = rows_at(slot, L, K, TM, RE);
    if (i + 1 < n_steps) prefetch(i + 1);

    // a thread beyond the last walker only copies rows and meets the barrier
    if (live) {
      const int u = __ldg(my_useq + i);
      int8_t* cu = s_occ + u * nt + tid;
      const int a = *cu;
      const uint2 bits = draws.at(i, rng_mode);  // (r_u, r_j)
      int b;
      int8_t* cv = cu;
      bool is_move = true;
      double dE;
      if (MOVE == kSwap) {
        const Rows rv = rows_at(slot + rb, L, K, TM, RE);
        const int v = __ldg(my_vseq + i);
        cv = s_occ + v * nt + tid;
        b = *cv;
        is_move = a != b;
        dE = swap_delta<KT, EW>(ru, rv, u, v, cu, a, b, s_occ, nt, tid, R, L, K,
                                TM, ew_c);
      } else {
        const int nc = max(__ldg(ncode + u) - 1, 1);
        const int j = (int)(bits.y % (uint32_t)nc);
        b = j + (j >= a ? 1 : 0);
        dE = flip_delta<KT, EW>(ru, u, a, b, s_occ, nt, tid, R, L, K, TM, C, mu,
                                ew_c);
      }

      // the Wang-Landau rule on the proposed bin
      const double e_new = e + dE;
      const double w_new = e_new - p.min_enthalpy;
      const size_t at_new = (size_t)wl_bin(w_new, p.bin_size, B) * W + wc;
      const bool in_win = w_new >= 0.0 && w_new < p.span;
      // h and o are used on accept only; loaded here so that they share
      // S[b']'s round trip
      const double s_new = entropy[at_new];
      const int h_new = hist[at_new];
      const int o_new = occr[at_new];
      if (in_win && is_move && accept_exponent((float)(s_cur - s_new), bits.x)) {
        if (MOVE == kSwap) {
          *cv = (int8_t)a;
        } else {
          *cu = (int8_t)b;
        }
        e = e_new;
        w_cur = w_new;
        at = at_new;
        s_cur = s_new;
        h_cur = h_new;
        o_cur = o_new;
        ++nacc;
      } else if (MOVE == kSwap) {
        *cu = (int8_t)a;
      }

      // the bookkeeping at the (possibly new) current state
      if (w_cur >= 0.0 && w_cur < p.span) {
        ++cnt;
        if (cnt % p.update_period == 0) {
          s_cur += modf;
          ++h_cur;
          ++o_cur;
          entropy[at] = s_cur;
          hist[at] = h_cur;
          occr[at] = o_cur;
        }
      }

      // the flatness check, on this launch's step count
      if ((i + 1) % p.check_period == 0 || i + 1 == n_steps) {
        int nvis = 0;
        int hmin = INT_MAX;
        long long hsum = 0;
#pragma unroll 4
        for (int bin = 0; bin < B; ++bin) {
          const double s = entropy[(size_t)bin * W + wc];
          const int h = hist[(size_t)bin * W + wc];
          if (s > 0.0) {
            ++nvis;
            hsum += h;
            hmin = min(hmin, h);
          }
        }
        const float hmean = (float)hsum / (float)max(nvis, 1);
        if (nvis >= 2 && (float)hmin > p.flatness * hmean) {
          for (int bin = 0; bin < B; ++bin) {
            hist[(size_t)bin * W + wc] = 0;
          }
          h_cur = 0;
          modf /= p.mod_divisor;
        }
      }
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
    mod_factor[w] = modf;
    wl_counter[w] = cnt;
  }
}

template <int MOVE>
auto pick_kernel(bool ew, int K) {
  return ew ? (K == 3 ? wl_chain_kernel<MOVE, 3, true> : wl_chain_kernel<MOVE, 0, true>)
            : (K == 3 ? wl_chain_kernel<MOVE, 3, false> : wl_chain_kernel<MOVE, 0, false>);
}

}  // namespace

extern "C" int smol_wl_chain(void* occ, void* enthalpy, void* naccept,
                             void* entropy, void* hist, void* occr,
                             void* mod_factor, void* wl_counter,
                             const void* useq, const void* vseq,
                             int seq_stride, const void* seed, const void* nbr,
                             const void* stride, const void* d2, const void* g,
                             const void* mu, const void* ncode,
                             const void* ew_v, const void* ew_c, int R, int L,
                             int K, int TM, int C, int W, int block_size,
                             int n_steps, int rng_mode, int move,
                             int num_levels, int check_period,
                             int update_period, double min_enthalpy,
                             double bin_size, double span, double mod_divisor,
                             float flatness, void* stream) {
  if (move != kFlip && move != kSwap) return (int)cudaErrorInvalidValue;
  const int threads = block_threads(W, block_size);
  const bool ew = ew_v != nullptr;
  const int row_sets = move == kSwap ? 4 : 2;
  const size_t smem = row_sets * rows_bytes(L, K, TM, ew ? R : 0) + (size_t)R * threads;
  auto kernel = move == kSwap ? pick_kernel<kSwap>(ew, K) : pick_kernel<kFlip>(ew, K);
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
  const int blocks = (W + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (int8_t*)occ, (double*)enthalpy, (int32_t*)naccept, (double*)entropy,
      (int32_t*)hist, (int32_t*)occr, (double*)mod_factor,
      (int32_t*)wl_counter, (const int32_t*)useq, (const int32_t*)vseq,
      seq_stride, (const int64_t*)seed, (const int32_t*)nbr,
      (const int32_t*)stride, (const int32_t*)d2, (const double*)g,
      (const double*)mu, (const int32_t*)ncode, (const double*)ew_v, (const double*)ew_c, R, L, K,
      TM, C, W, block_size, n_steps, rng_mode, p);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// SQS distance-annealing chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of smol_tpu/ops/pallas_sqs.py (make_distance_chain
// :355, `kernel` :394, pallas_call :649): canonical swaps annealed against
// the correlation distance d = -w L + sum_f W_f |f_f - T_f|, each walker
// with its own intensive feature vector f, its score d and its best (score,
// occupancy).  Exogenous pairs (u, v) are shared by the walkers of a
// sequence group, the random bits are Philox or the reference's hash
// (chain_common.cuh):
//
// - A rank's local rows (one per local cluster and correlation function of
//   its orbit) hold their neighbour ranks and strides, their self stride
//   d2 and their tensor's values corr_flat / fn_cluster_count in f64, and
//   are sorted by feature: rows seg[f] .. seg[f + 1] - 1 feed feature f.
//   Nothing of the TPU layout (bf16 stride planes, the 0/1 scatter matrix
//   on the MXU, extent segments with select loops) is kept: a row's value
//   change is two direct lookups, g[t_new] - g[t_old].
// - The step's feature change df[f] sums, in f64, u's rows going a -> b,
//   then v's going b -> a against the occupancy with u already holding b
//   (written into u's shared cell, and a put back on reject), as the
//   reference (:416, :527-537).
// - d_new from f + df: |f + df - T| per feature, the weighted sum in the
//   order of the diameter groups with every product and sum rounded on its
//   own (__dmul_rn, __dadd_rn: no fused multiply-add, which the plain torch
//   twin in ops/sqs.py cannot reproduce), L the diameter of the last group
//   of the leading run of groups whose features all lie within match_tol
//   (:494-510), then minus w * L.
// - Accept on the f32 exponent -beta32 * (float)(d_new - d), as the
//   reference decides (:544-546), with its acceptance bits (slot 1 of the
//   hash); a null pair (a == b) is never accepted.  After every step, a
//   walker whose d is below its best takes d and its codes as its best
//   (:561-563).
//
// Lanes.  A walker is G consecutive threads of one warp (G = 1, 2, 4, 8 or
// 16, `lanes`; one lane has its own instantiation, ONE_LANE, with no warp
// synchronisation), and a block holds `walkers_per_block` walkers of one
// sequence group.  Lane j takes rows seg[f] + j, seg[f] + j + G, ... of
// each feature f, u's then v's, into its own partial df[FMAX] in row order;
// the G partials then meet in a butterfly of __shfl_xor_sync (xor 1, 2,
// 4, ...), after which every lane holds the same bits (f64 addition
// commutes) and computes the score and the decision itself.  F is bounded
// by the template's FMAX and each feature's loop is unrolled over f, so no
// register array is indexed at run time.  Lane 0 writes the walker's
// shared codes; a __syncwarp over the walker's lanes orders the write of b
// into u's cell before v's rows, and the decision's writes before the next
// step.  The best-codes copy and the codes' load and store are split
// across the lanes.  At G = 1 this is the one-thread-per-walker chain.
//
// Tables.  A rank's rows are read unpacked (Rows: d2, K ranks, K strides,
// 2 K + 1 loads a row) or, for K <= 3 and F <= 8, packed (PackedRows: one
// 8-byte load a row, ops/sqs.py pack_rows; 38.6 KB for the 8 ranks of an
// 8-site shape, against 49.3 KB unpacked).  Where all R ranks' row sets fit
// in shared memory beside the block's codes (`resident`; the launcher's
// shared-memory budget decides, from the shapes), the block copies them
// once with cp.async and runs every step with no block barrier: only the
// lanes of one walker synchronise.  Otherwise (the 64-site shape, 315 KB
// packed) the next step's rows of u and v are streamed into a second
// buffer with cp.async while this step runs (K8), behind one block barrier
// a step.
//
// Batches.  One launch runs S shapes of one size: every per-walker operand
// is [S, ...] shape-major, the tables are padded to the batch's largest L
// (rows past a rank's seg end are never read), and block b serves shape
// b / blocks_per_shape.  A walker draws with its index within its shape,
// its shape's seed and its shape's pair sequences, so a batched launch
// equals the S launches of one shape each, at the same lanes, bit for bit.
//
// What bounds it on this card: not the roofline (chip_smoke.py
// `distance_bound`: the operations this launch's data needs, two f64
// operations a row read and 4 F + 3 a non-null proposal, at the card's f64
// rate; the kernel is two orders of magnitude above it, PERF.md).  One
// shape's 2048 walkers are latency-bound: each step is a chain of
// shared-memory loads per row (rows -> codes -> lookups), so the lanes cut
// the rows a thread walks in turn by G and put G times more warps on the
// card (G = 16 there).  A batch that fills the card (the 20 8-site shapes:
// 40960 walkers, about 10 warps an SM at one lane) is bound by the
// instructions and shared-memory loads issued, so it runs at one lane,
// where no lane repeats the score, the draws and the decision, and with
// packed rows (ops/sqs.py launch_lanes picks G from the launch's walkers).
//
// occ and best_occ ([S, R, W] int8, rank-major), feat ([S, F, W] f64), d,
// best_d and naccept ([S, W]) are updated in place.  The C entry point
// returns cudaGetLastError() after the launch.

#include "chain_common.cuh"

namespace {

using namespace smol;

constexpr int kDistanceThreads = 256;  // most threads of a block: walkers x lanes

// The segment starts of every rank, [R, F + 1] int32, kept in shared memory.
__host__ __device__ __forceinline__ size_t seg_bytes(int R, int F) {
  return ((size_t)R * (F + 1) * 4 + 15) / 16 * 16;
}

// One rank's rows packed (ops/sqs.py pack_rows): the lookups g [L, TM] f64,
// then per row one 8-byte word pair: d2 and three slots' ranks in bytes of
// x, their strides in bytes of y (an empty slot: rank 0, stride 0).
struct PackedRows {
  double* g;
  int2* meta;
};

__host__ __device__ __forceinline__ size_t packed_rows_bytes(int L, int TM) {
  return ((size_t)L * TM * 8 + (size_t)L * 8 + 15) / 16 * 16;
}

__device__ __forceinline__ PackedRows packed_rows_at(unsigned char* base, int L, int TM) {
  PackedRows r;
  r.g = reinterpret_cast<double*>(base);
  r.meta = reinterpret_cast<int2*>(r.g + (size_t)L * TM);
  return r;
}

// Issue the asynchronous copy of rank u's packed rows into `dst` (all threads).
__device__ __forceinline__ void copy_packed_rows(const PackedRows& dst, int u,
                                                 const int2* __restrict__ meta,
                                                 const double* __restrict__ g, int L,
                                                 int TM, int tid, int nt) {
  const double* g_u = g + (size_t)u * L * TM;
  for (int x = tid; x < L * TM; x += nt) {
    __pipeline_memcpy_async(dst.g + x, g_u + x, sizeof(double));
  }
  const int2* m_u = meta + (size_t)u * L;
  for (int x = tid; x < L; x += nt) {
    __pipeline_memcpy_async(dst.meta + x, m_u + x, sizeof(int2));
  }
  __pipeline_commit();
}

// A row's table index t at code a (d2 a + sum_k stride code(rank)) and its
// self stride d2, from the unpacked rows (2 K + 1 loads) or the packed ones
// (one 8-byte load: the same integers, so the same lookups).
template <int KT>
__device__ __forceinline__ int2 row_index(const Rows& rows, int j, const int8_t* codes,
                                          int pitch, int K_rt, int a) {
  const int K = KT > 0 ? KT : K_rt;
  const int d = rows.d2[j];
  int t = d * a;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = rows.nbr[j * K + k];
    const int code = n >= 0 ? (int)codes[n * pitch] : 0;
    t += rows.st[j * K + k] * code;
  }
  return make_int2(t, d);
}

template <int KT>
__device__ __forceinline__ int2 row_index(const PackedRows& rows, int j,
                                          const int8_t* codes, int pitch, int, int a) {
  const int2 m = rows.meta[j];
  const unsigned x = (unsigned)m.x;
  const unsigned y = (unsigned)m.y;
  const int d = x & 0xFF;
  const int t = d * a + (int)(y & 0xFF) * codes[((x >> 8) & 0xFF) * pitch] +
                (int)((y >> 8) & 0xFF) * codes[((x >> 16) & 0xFF) * pitch] +
                (int)((y >> 16) & 0xFF) * codes[(x >> 24) * pitch];
  return make_int2(t, d);
}

// One lane: df[f] += the change of each of the rank's rows of feature f
// (rows seg[f] .. seg[f + 1] - 1) going from code a to b, every row in
// order, the row index running on from feature to feature and the
// segment starts `seg` read from device memory; unrolled by 4, so that one
// row's dependent shared loads overlap the next rows'.  On an H100 this
// loop runs the one-lane launch 29 % faster (unpacked rows) and 11 %
// faster (packed) than the lanes' loop below at one lane.  `codes` is the
// walker's column of the block's codes.
template <int KT, class RowsT, int FMAX>
__device__ __forceinline__ void add_rows_in_order(double (&df)[FMAX], const RowsT& rows,
                                                  const int32_t* __restrict__ seg,
                                                  const int8_t* codes, int pitch, int K_rt,
                                                  int TM, int F, int a, int b) {
  int j = __ldg(seg);
#pragma unroll
  for (int f = 0; f < FMAX; ++f) {
    if (f < F) {
      const int end = __ldg(seg + f + 1);
      double acc = df[f];
#pragma unroll 4
      for (; j < end; ++j) {
        const int2 td = row_index<KT>(rows, j, codes, pitch, K_rt, a);
        const double term = rows.g[j * TM + td.x + td.y * (b - a)] - rows.g[j * TM + td.x];
        acc += term;
      }
      df[f] = acc;
    }
  }
}

// Several lanes: df[f] += the change of this lane's rows of feature f (rows
// seg[f] + lane, seg[f] + lane + lanes, ... before seg[f + 1], in order);
// `seg` in shared memory.  A lane has only 1-6 rows of a feature here, and
// the loop runs faster not unrolled (an H100: -21 % at 16 lanes).
template <int KT, class RowsT, int FMAX>
__device__ __forceinline__ void add_lane_rows(double (&df)[FMAX], const RowsT& rows,
                                              const int32_t* seg, const int8_t* codes,
                                              int pitch, int K_rt, int TM, int F, int lane,
                                              int shift, int a, int b) {
  const int lanes = 1 << shift;
#pragma unroll
  for (int f = 0; f < FMAX; ++f) {
    if (f < F) {
      const int first = seg[f] + lane;
      const int count = (seg[f + 1] - first + lanes - 1) >> shift;  // this lane's rows
      double acc = df[f];
#pragma unroll 1
      for (int q = 0; q < count; ++q) {
        const int j = first + q * lanes;
        const int2 td = row_index<KT>(rows, j, codes, pitch, K_rt, a);
        const double term = rows.g[j * TM + td.x + td.y * (b - a)] - rows.g[j * TM + td.x];
        acc += term;
      }
      df[f] = acc;
    }
  }
}

// The row sets of a launch: unpacked (Rows, any K) or packed (K <= 3).
template <bool PACKED>
struct RowSets {
  using T = Rows;
  static __host__ __device__ size_t bytes(int L, int K, int TM) {
    return rows_bytes(L, K, TM, 0);
  }
  static __device__ T at(unsigned char* base, int L, int K, int TM) {
    return rows_at(base, L, K, TM, 0);
  }
  static __device__ void copy(unsigned char* dst, int u, const int32_t* nbr,
                              const int32_t* stride, const int32_t* d2, const int2*,
                              const double* g, int L, int K, int TM, int tid, int nt) {
    copy_rows(rows_at(dst, L, K, TM, 0), u, nbr, stride, d2, g, nullptr, L, K, TM, 0,
              tid, nt);
  }
};

template <>
struct RowSets<true> {
  using T = PackedRows;
  static __host__ __device__ size_t bytes(int L, int, int TM) {
    return packed_rows_bytes(L, TM);
  }
  static __device__ T at(unsigned char* base, int L, int, int TM) {
    return packed_rows_at(base, L, TM);
  }
  static __device__ void copy(unsigned char* dst, int u, const int32_t*, const int32_t*,
                              const int32_t*, const int2* meta, const double* g, int L,
                              int, int TM, int tid, int nt) {
    copy_packed_rows(packed_rows_at(dst, L, TM), u, meta, g, L, TM, tid, nt);
  }
};

// The score of features fn: sum_f W_f |fn_f - T_f| - w L (see the top).
template <int FMAX>
__device__ __forceinline__ double score(const double (&fn)[FMAX], const double* s_t,
                                        const double* s_w, const int* s_last,
                                        const double* s_gd, int F, double tol,
                                        double mw) {
  double dsum = 0.0;
  double ell = 0.0;
  bool running = true;
  bool group_ok = true;
#pragma unroll
  for (int f = 0; f < FMAX; ++f) {
    if (f < F) {
      const double x = fabs(__dsub_rn(fn[f], s_t[f]));
      dsum = __dadd_rn(dsum, __dmul_rn(s_w[f], x));
      group_ok = group_ok && x <= tol;
      if (s_last[f]) {  // f ends its diameter group
        running = running && group_ok;
        if (running) ell = fmax(ell, s_gd[f]);
        group_ok = true;
      }
    }
  }
  return __dsub_rn(dsum, __dmul_rn(mw, ell));
}

template <int KT, int FMAX, bool PACKED, bool ONE_LANE>
__global__ void __launch_bounds__(kDistanceThreads)
distance_chain_kernel(int8_t* __restrict__ occ, int8_t* __restrict__ best_occ,
                      double* __restrict__ feat, double* __restrict__ dist,
                      double* __restrict__ best, int32_t* __restrict__ naccept,
                      const float* __restrict__ beta,
                      const int32_t* __restrict__ useq,
                      const int32_t* __restrict__ vseq, int seq_stride,
                      int seq_shape_stride, const int64_t* __restrict__ seeds,
                      const int32_t* __restrict__ nbr,
                      const int32_t* __restrict__ stride,
                      const int32_t* __restrict__ d2,
                      const double* __restrict__ g,
                      const int32_t* __restrict__ seg,
                      const double* __restrict__ target,
                      const double* __restrict__ weight,
                      const int32_t* __restrict__ group_last,
                      const double* __restrict__ group_diameter,
                      const double* __restrict__ match,
                      const int2* __restrict__ meta, int R, int L, int K_rt,
                      int TM, int F, int W, int block_size, int n_steps,
                      int rng_mode, int lanes, int walkers_per_block,
                      int resident) {
  using Sets = RowSets<PACKED>;
  if (ONE_LANE) lanes = 1;
  const int K = KT > 0 ? KT : K_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_t[FMAX], s_w[FMAX], s_gd[FMAX];
  __shared__ int s_last[FMAX];
  // the rows: every rank's (resident), or two slots (this step, next
  // step) of u's then v's; then the segment starts, the codes, the best codes
  const size_t rb = Sets::bytes(L, K, TM);
  const int pitch = code_pitch(walkers_per_block);
  int32_t* s_seg = reinterpret_cast<int32_t*>(smem + (resident ? R : 4) * rb);
  int8_t* s_occ = reinterpret_cast<int8_t*>(s_seg) + seg_bytes(R, F);
  int8_t* s_best = s_occ + (size_t)R * pitch;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int shift = ONE_LANE ? 0 : __ffs(lanes) - 1;  // lanes is a power of two
  const int wl = tid >> shift;         // the walker within the block
  const int lane = tid & (lanes - 1);  // the lane within the walker
  const unsigned group = lanes == 1 ? 1u : (1u << lanes) - 1u;
  const unsigned mask = group << ((tid & 31) & ~(lanes - 1));  // the walker's lanes

  // this block's shape s and its first walker w0 within the shape
  const int blocks_per_shape = (W + walkers_per_block - 1) / walkers_per_block;
  const int s = blockIdx.x / blocks_per_shape;
  const int w0 = (blockIdx.x % blocks_per_shape) * walkers_per_block;
  const int w = w0 + wl;
  const bool live = w < W;
  const int wc = live ? w : W - 1;
  occ += (size_t)s * R * W;
  best_occ += (size_t)s * R * W;
  feat += (size_t)s * F * W;
  dist += (size_t)s * W;
  best += (size_t)s * W;
  naccept += (size_t)s * W;
  beta += (size_t)s * W;
  nbr += (size_t)s * R * L * K;
  stride += (size_t)s * R * L * K;
  d2 += (size_t)s * R * L;
  g += (size_t)s * R * L * TM;
  if (PACKED) meta += (size_t)s * R * L;
  seg += (size_t)s * R * (F + 1);
  target += (size_t)s * F;
  weight += (size_t)s * F;
  group_last += (size_t)s * F;
  group_diameter += (size_t)s * F;
  const double match_tol = match[2 * s];
  const double match_weight = match[2 * s + 1];

  for (int f = tid; f < F; f += nt) {
    s_t[f] = target[f];
    s_w[f] = weight[f];
    s_gd[f] = group_diameter[f];
    s_last[f] = group_last[f];
  }
  for (int x = tid; x < R * (F + 1); x += nt) s_seg[x] = seg[x];
  for (int x = tid; x < R * walkers_per_block; x += nt) {
    const int r = x / walkers_per_block;
    const int c = x % walkers_per_block;
    const size_t at = (size_t)r * W + min(w0 + c, W - 1);
    s_occ[r * pitch + c] = occ[at];
    s_best[r * pitch + c] = best_occ[at];
  }
  int8_t* codes = s_occ + wl;
  double cur[FMAX];  // the walker's features
#pragma unroll
  for (int k = 0; k < FMAX; ++k) cur[k] = k < F ? feat[(size_t)k * W + wc] : 0.0;
  double d_cur = dist[wc];
  double bd = best[wc];
  const float b32 = beta[wc];
  int nacc = 0;

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = w0 / block_size;
  const int32_t* my_useq = useq + (size_t)s * seq_shape_stride + (size_t)grp * seq_stride;
  const int32_t* my_vseq = vseq + (size_t)s * seq_shape_stride + (size_t)grp * seq_stride;
  const Draws draws(seeds[s], grp, wc, block_size);

  auto prefetch = [&](int i) {  // step i's rows of u and v into slot i & 1
    unsigned char* slot = smem + (i & 1) * 2 * rb;
    Sets::copy(slot, __ldg(my_useq + i), nbr, stride, d2, meta, g, L, K, TM, tid, nt);
    Sets::copy(slot + rb, __ldg(my_vseq + i), nbr, stride, d2, meta, g, L, K, TM, tid,
               nt);
  };
  if (resident) {
    for (int r = 0; r < R; ++r) {
      Sets::copy(smem + r * rb, r, nbr, stride, d2, meta, g, L, K, TM, tid, nt);
    }
  } else if (n_steps > 0) {
    prefetch(0);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    const int u = __ldg(my_useq + i);
    const int v = __ldg(my_vseq + i);
    unsigned char* slot = smem + (i & 1) * 2 * rb;
    const typename Sets::T ru = Sets::at(resident ? smem + u * rb : slot, L, K, TM);
    const typename Sets::T rv = Sets::at(resident ? smem + v * rb : slot + rb, L, K, TM);
    if (!resident && i + 1 < n_steps) prefetch(i + 1);

    int8_t* cu = codes + u * pitch;
    int8_t* cv = codes + v * pitch;
    const int a = *cu;
    const int b = *cv;
    double df[FMAX];
#pragma unroll
    for (int k = 0; k < FMAX; ++k) df[k] = 0.0;
    if constexpr (ONE_LANE) {
      add_rows_in_order<KT>(df, ru, seg + u * (F + 1), codes, pitch, K, TM, F, a, b);
      *cu = (int8_t)b;  // v's rows see u already holding b
      add_rows_in_order<KT>(df, rv, seg + v * (F + 1), codes, pitch, K, TM, F, b, a);
    } else {
      add_lane_rows<KT>(df, ru, s_seg + u * (F + 1), codes, pitch, K, TM, F, lane, shift,
                        a, b);
      __syncwarp(mask);  // every lane has read a before it changes
      if (lane == 0) *cu = (int8_t)b;  // v's rows see u already holding b
      __syncwarp(mask);
      add_lane_rows<KT>(df, rv, s_seg + v * (F + 1), codes, pitch, K, TM, F, lane, shift,
                        b, a);
    }
    for (int m = 1; m < lanes; m <<= 1) {  // the lanes' partials meet
#pragma unroll
      for (int k = 0; k < FMAX; ++k) df[k] += __shfl_xor_sync(mask, df[k], m);
    }
    double fn[FMAX];
#pragma unroll
    for (int k = 0; k < FMAX; ++k) fn[k] = cur[k] + df[k];
    const double d_new = score<FMAX>(fn, s_t, s_w, s_last, s_gd, F, match_tol,
                                     match_weight);

    if (!ONE_LANE) __syncwarp(mask);  // every lane has read v's rows' codes
    if (a != b && metropolis(b32, d_new - d_cur, draws.at(i, rng_mode).x)) {
      if (lane == 0) *cv = (int8_t)a;
#pragma unroll
      for (int k = 0; k < FMAX; ++k) cur[k] = fn[k];
      d_cur = d_new;
      ++nacc;
    } else if (lane == 0) {
      *cu = (int8_t)a;
    }
    if (!ONE_LANE) __syncwarp(mask);  // the decision's writes, before the next step
    if (d_cur < bd) {
      bd = d_cur;
      for (int r = lane; r < R; r += lanes) s_best[r * pitch + wl] = codes[r * pitch];
    }
    if (!resident) {
      __pipeline_wait_prior(0);
      __syncthreads();
    }
  }

  __syncthreads();
  for (int x = tid; x < R * walkers_per_block; x += nt) {
    const int r = x / walkers_per_block;
    const int c = x % walkers_per_block;
    if (w0 + c < W) {
      occ[(size_t)r * W + w0 + c] = s_occ[r * pitch + c];
      best_occ[(size_t)r * W + w0 + c] = s_best[r * pitch + c];
    }
  }
  if (live && lane == 0) {
#pragma unroll
    for (int k = 0; k < FMAX; ++k) {
      if (k < F) feat[(size_t)k * W + w] = cur[k];
    }
    dist[w] = d_cur;
    best[w] = bd;
    naccept[w] += nacc;
  }
}

// ---- the wide body: any F, each step's rows staged in shared memory ----
//
// The bodies above keep a walker's features and feature change in registers,
// unrolled over FMAX <= 32, and its pair's rows in shared memory.  Above 32
// features (the 41-feature Au-Cu FCC distance of up to 2084 rows a rank),
// and wherever their streamed row sets do not fit, the wide body runs
// instead:
//
// - A row's values are its feature's (corr_flat / fn_cluster_count of its
//   function), so one table gf [F, TM] f64 in shared memory serves every
//   rank's rows.  Each walker keeps f and fn in two shared buffers
//   [2][F][walkers] (feature-major: a warp's walkers read consecutive
//   words); an accept swaps them.  Lane f mod G writes fn[f].
// - Every walker of a block reads the same rows in a step (they share the
//   pair (u, v)), so the block stages them: one thread issues Tensor Memory
//   Accelerator bulk copies (cp.async.bulk, completion on an mbarrier) of
//   u's and v's rows from device memory into a ring of two stages, a chunk
//   ahead of the walkers, and the walkers read each row by shared-memory
//   broadcast.  A chunk is a run of features whose rows of u and of v fit
//   one stage; a block barrier after each chunk frees its stage for the
//   copy two chunks on.  The stages take what two blocks an SM leave of its
//   shared memory (ops/sqs.py wide_plan; 128 registers a thread), so two
//   blocks share an SM: for the 41-feature distance 115704 bytes a block,
//   a step's 33344 bytes of rows in two chunks.
// - Rows come in one of two layouts (ops/sqs.py pack_rank_rows,
//   pack_slot_rows).  Rank rows, where R <= 8 and a row's strides summed
//   on any rank and its self stride d2 are below 256: one byte a rank, the
//   row's strides summed on that rank and, on its own rank, d2.  The walker
//   holds its codes in registers, one byte a rank, so a row's table index t
//   is a dot product of bytes (__dp4a) with the codes before the swap, and
//   t + d2 (b - a) the same with the codes after the row's own change: no
//   code loads, no decode.  Slot rows take any row: d2, the K ranks and the
//   K strides as int32, the codes read from the block's codes in shared
//   memory (u's cell holds b from the start of the step: u's rows never
//   read u, and v's rows must see b there).
// - Feature by feature: u's rows (a -> b), then v's (b -> a), each lane its
//   rows j, j + G, ... of the feature in order into one f64 register; the
//   lanes' partials meet in the __shfl_xor_sync butterfly; fn = f + df, its
//   term of the score summed on at once.  This is the other bodies' order:
//   their df[f] is also u's rows of f, then v's, from 0.
//
// So the wide body equals the plain torch twin (ops/sqs.py
// distance_chain_reference) bit for bit, in both RNG modes, at every lane
// count.  What bounds it on this card: the instructions and shared-memory
// loads a row issues (three loads with rank rows: the row, two values) and
// their latency, which the 16 warps of two blocks an SM hide in part; its
// rows' bytes from device memory, about 33 KB a step a block for the
// 41-feature distance, are a few percent of the L2 cache's rate.

constexpr int kWideThreads = 256;  // most threads of a block of the wide body
constexpr int kWideBlocks = 2;     // its blocks an SM: 128 registers a thread
constexpr int kStages = 2;         // the ring's stages

// Dynamic shared memory of a block of the wide body (ops/sqs.py
// wide_shared_bytes): the ring's stages and their mbarriers; gf [F, TM], the
// score's constants [3][F] and each walker's f and fn [2][F][walkers] in
// f64; the group ends [F] and the segment starts [R][F + 1] in int32; the
// codes and the best codes.
__host__ __device__ __forceinline__ size_t wide_shared_bytes(int R, int F, int TM,
                                                             int walkers_per_block,
                                                             int stage_bytes) {
  const size_t doubles = (size_t)F * (TM + 3 + 2 * walkers_per_block) * 8;
  const size_t ints = ((size_t)F + (size_t)R * (F + 1)) * 4;
  return (size_t)kStages * stage_bytes + 16 + doubles + align16(ints) +
         2 * (size_t)R * code_pitch(walkers_per_block);
}

// Bytes of a slot row: d2, K ranks, K strides (int32), padded to 16.
__host__ __device__ __forceinline__ int slot_row_bytes(int K) {
  return (int)align16((size_t)(1 + 2 * K) * 4);
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void stage_barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_address(bar))
               : "memory");
}

// The producer's one arrival on a stage's barrier, which then waits for
// `bytes` of bulk copies.
__device__ __forceinline__ void stage_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// Wait until the phase of `bar` of this parity has completed.
__device__ __forceinline__ void stage_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Rows j0 .. j1 - 1 of a rank as one bulk copy moves them: from the 16-byte
// boundary at or below row j0 to the one at or above row j1 (a rank's rows
// start on a boundary: ops/sqs.py pads each rank to row_pitch rows).
__device__ __forceinline__ int part_begin(int j0, int rb) { return (j0 * rb) & ~15; }

__device__ __forceinline__ int part_bytes(int j0, int j1, int rb) {
  return j1 > j0 ? ((j1 * rb + 15) & ~15) - part_begin(j0, rb) : 0;
}

// The end of the chunk that starts at feature f0 of the pair whose segment
// starts are seg_u and seg_v: the most features whose rows of u and of v fit
// one stage, at least one (the plan's stage holds any one feature's).
__device__ __forceinline__ int chunk_end(const int32_t* seg_u, const int32_t* seg_v,
                                         int f0, int F, int rb, int stage_bytes) {
  auto bytes = [&](int f1) {
    return part_bytes(seg_u[f0], seg_u[f1], rb) + part_bytes(seg_v[f0], seg_v[f1], rb);
  };
  if (bytes(F) <= stage_bytes) return F;
  int f1 = f0 + 1;
  while (f1 < F && bytes(f1 + 1) <= stage_bytes) ++f1;
  return f1;
}

// The ring's producer, held by thread 0: the chunks of the steps in order,
// chunk k into stage k mod kStages.
struct StageRing {
  unsigned char* stages;
  uint64_t* bars;
  const unsigned char* rows;  // the shape's rows, rank_bytes a rank
  size_t rank_bytes;
  const int32_t* seg;  // [R][F + 1] in shared memory
  const int32_t* useq;
  const int32_t* vseq;
  int rb, stage_bytes, F, n_steps;
  int step = 0, f = 0, k = 0;  // the next chunk: its step, first feature, index

  __device__ void issue() {
    if (step >= n_steps) return;
    const int u = __ldg(useq + step);
    const int v = __ldg(vseq + step);
    const int32_t* su = seg + u * (F + 1);
    const int32_t* sv = seg + v * (F + 1);
    const int f1 = chunk_end(su, sv, f, F, rb, stage_bytes);
    const int bu = part_bytes(su[f], su[f1], rb);
    const int bv = part_bytes(sv[f], sv[f1], rb);
    unsigned char* dst = stages + (size_t)(k % kStages) * stage_bytes;
    uint64_t* bar = bars + k % kStages;
    stage_expect(bar, (uint32_t)(bu + bv));
    if (bu) bulk_copy(dst, rows + u * rank_bytes + part_begin(su[f], rb), bu, bar);
    if (bv) bulk_copy(dst + bu, rows + v * rank_bytes + part_begin(sv[f], rb), bv, bar);
    ++k;
    f = f1;
    if (f == F) {
      f = 0;
      ++step;
    }
  }
};

// A walker's codes in registers, a byte a rank: rank r's in byte r mod 4 of
// c.x (r < 4) or c.y.
__device__ __forceinline__ int code_of(uint2 c, int r) {
  return (int)(((r < 4 ? c.x : c.y) >> ((r & 3) * 8)) & 0xFFu);
}

__device__ __forceinline__ uint2 with_code(uint2 c, int r, int code) {
  const int sh = (r & 3) * 8;
  const uint32_t keep = ~(0xFFu << sh), put = (uint32_t)code << sh;
  return r < 4 ? make_uint2((c.x & keep) | put, c.y) : make_uint2(c.x, (c.y & keep) | put);
}

// One lane: acc += the change of this lane's rank rows j = first, first +
// lanes, ... before end (in order), row j at rows + 8 j; gf the feature's
// values; the row's index t with the codes before its change (cf), t + d2
// (b - a) with those after (ct).
__device__ __forceinline__ double add_rank_rows(double acc, const unsigned char* rows,
                                                const double* gf, int first, int end,
                                                uint2 cf, uint2 ct, int shift) {
  const int count = (end - first + (1 << shift) - 1) >> shift;  // this lane's rows
  const uint2* p = reinterpret_cast<const uint2*>(rows) + first;
#pragma unroll 4
  for (int q = 0; q < count; ++q) {
    const uint2 m = p[q << shift];
    const int t = (int)__dp4a(m.x, cf.x, __dp4a(m.y, cf.y, 0u));
    const int tn = (int)__dp4a(m.x, ct.x, __dp4a(m.y, ct.y, 0u));
    acc += gf[tn] - gf[t];
  }
  return acc;
}

// The same from slot rows (row j at rows + j * rb), the codes in shared memory.
__device__ __forceinline__ double add_slot_rows(double acc, const unsigned char* rows,
                                                const double* gf, int first, int end,
                                                const int8_t* codes, int pitch, int K,
                                                int rb, int shift, int a, int b) {
  const int lanes = 1 << shift;
  const int count = (end - first + lanes - 1) >> shift;
#pragma unroll 2
  for (int q = 0; q < count; ++q) {
    const int32_t* row = reinterpret_cast<const int32_t*>(rows + (first + q * lanes) * rb);
    const int d = row[0];
    int t = d * a;
    for (int k = 0; k < K; ++k) t += row[1 + K + k] * (int)codes[row[1 + k] * pitch];
    acc += gf[t + d * (b - a)] - gf[t];
  }
  return acc;
}

// RANK: rank rows (8 bytes, R <= 8), else slot rows.
template <bool RANK>
__global__ void __launch_bounds__(kWideThreads, kWideBlocks)
distance_chain_wide_kernel(int8_t* __restrict__ occ, int8_t* __restrict__ best_occ,
                           double* __restrict__ feat, double* __restrict__ dist,
                           double* __restrict__ best, int32_t* __restrict__ naccept,
                           const float* __restrict__ beta,
                           const int32_t* __restrict__ useq,
                           const int32_t* __restrict__ vseq, int seq_stride,
                           int seq_shape_stride, const int64_t* __restrict__ seeds,
                           const unsigned char* __restrict__ rows,
                           const double* __restrict__ gfeat,
                           const int32_t* __restrict__ seg,
                           const double* __restrict__ target,
                           const double* __restrict__ weight,
                           const int32_t* __restrict__ group_last,
                           const double* __restrict__ group_diameter,
                           const double* __restrict__ match, int R, int K, int TM, int F,
                           int W, int block_size, int n_steps, int rng_mode, int lanes,
                           int walkers_per_block, int row_pitch, int stage_bytes) {
  const int rb = RANK ? 8 : slot_row_bytes(K);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int wpb = walkers_per_block;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_stage = smem;  // [kStages][stage_bytes]
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + (size_t)kStages * stage_bytes);
  double* s_g = reinterpret_cast<double*>(smem + (size_t)kStages * stage_bytes + 16);
  double* s_t = s_g + (size_t)F * TM;
  double* s_w = s_t + F;
  double* s_gd = s_w + F;
  double* s_f = s_gd + F;  // [2][F][wpb]: each walker's f and fn
  int32_t* s_last = reinterpret_cast<int32_t*>(s_f + 2 * (size_t)F * wpb);
  int32_t* s_seg = s_last + F;  // [R][F + 1]
  const size_t ints = ((size_t)F + (size_t)R * (F + 1)) * 4;
  int8_t* s_occ = reinterpret_cast<int8_t*>(s_last) + align16(ints);
  const int pitch = code_pitch(wpb);
  int8_t* s_best = s_occ + (size_t)R * pitch;

  const int shift = __ffs(lanes) - 1;  // lanes is a power of two
  const int wl = tid >> shift;         // the walker within the block
  const int lane = tid & (lanes - 1);  // the lane within the walker
  const unsigned group = lanes == 1 ? 1u : (1u << lanes) - 1u;
  const unsigned mask = group << ((tid & 31) & ~(lanes - 1));  // the walker's lanes

  const int blocks_per_shape = (W + wpb - 1) / wpb;
  const int s = blockIdx.x / blocks_per_shape;
  const int w0 = (blockIdx.x % blocks_per_shape) * wpb;
  const int w = w0 + wl;
  const bool live = w < W;
  const int wc = live ? w : W - 1;
  occ += (size_t)s * R * W;
  best_occ += (size_t)s * R * W;
  feat += (size_t)s * F * W;
  dist += (size_t)s * W;
  best += (size_t)s * W;
  naccept += (size_t)s * W;
  beta += (size_t)s * W;
  const size_t rank_bytes = (size_t)row_pitch * rb;
  rows += (size_t)s * R * rank_bytes;
  gfeat += (size_t)s * F * TM;
  seg += (size_t)s * R * (F + 1);
  target += (size_t)s * F;
  weight += (size_t)s * F;
  group_last += (size_t)s * F;
  group_diameter += (size_t)s * F;
  const double match_tol = match[2 * s];
  const double match_weight = match[2 * s + 1];

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) stage_barrier_init(s_bar + st);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int x = tid; x < F * TM; x += nt) s_g[x] = gfeat[x];
  for (int f = tid; f < F; f += nt) {
    s_t[f] = target[f];
    s_w[f] = weight[f];
    s_gd[f] = group_diameter[f];
    s_last[f] = group_last[f];
  }
  for (int x = tid; x < R * (F + 1); x += nt) s_seg[x] = seg[x];
  for (int x = tid; x < R * wpb; x += nt) {
    const int r = x / wpb;
    const int c = x % wpb;
    const size_t at = (size_t)r * W + min(w0 + c, W - 1);
    s_occ[r * pitch + c] = occ[at];
    s_best[r * pitch + c] = best_occ[at];
  }
  for (int k = lane; k < F; k += lanes) s_f[(size_t)k * wpb + wl] = feat[(size_t)k * W + wc];
  int8_t* codes = s_occ + wl;
  int cur = 0;  // the buffer of f; fn goes to the other
  double d_cur = dist[wc];
  double bd = best[wc];
  const float b32 = beta[wc];
  int nacc = 0;

  const int grp = w0 / block_size;
  const int32_t* my_useq = useq + (size_t)s * seq_shape_stride + (size_t)grp * seq_stride;
  const int32_t* my_vseq = vseq + (size_t)s * seq_shape_stride + (size_t)grp * seq_stride;
  const Draws draws(seeds[s], grp, wc, block_size);
  __syncthreads();

  uint2 cw = make_uint2(0u, 0u);  // rank rows: the walker's codes, a byte a rank
  if constexpr (RANK) {
    for (int r = 0; r < R; ++r) cw = with_code(cw, r, (uint8_t)codes[r * pitch]);
  }
  StageRing ring{s_stage, s_bar, rows, rank_bytes, s_seg, my_useq, my_vseq, rb,
                 stage_bytes, F, n_steps};
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) ring.issue();
  }
  int chunk = 0;  // the chunk the walkers take next

  for (int i = 0; i < n_steps; ++i) {
    const int u = __ldg(my_useq + i);
    const int v = __ldg(my_vseq + i);
    const int32_t* seg_u = s_seg + u * (F + 1);
    const int32_t* seg_v = s_seg + v * (F + 1);
    int8_t* cu = codes + u * pitch;
    int8_t* cv = codes + v * pitch;
    int a, b;
    uint2 c1 = cw, c2 = cw;  // rank rows: the codes after u's, v's change
    if constexpr (RANK) {
      a = code_of(cw, u);
      b = code_of(cw, v);
      c1 = with_code(cw, u, b);
      c2 = with_code(c1, v, a);
    } else {
      a = *cu;
      b = *cv;
      __syncwarp(mask);  // every lane has read a before it changes
      if (lane == 0) *cu = (int8_t)b;  // v's rows see u holding b; u's never read u
      __syncwarp(mask);
    }
    const double* f_cur = s_f + (size_t)cur * F * wpb + wl;
    double* f_new = s_f + (size_t)(cur ^ 1) * F * wpb + wl;
    double dsum = 0.0;
    double ell = 0.0;
    bool running = true;
    bool group_ok = true;
    for (int f0 = 0; f0 < F;) {
      const int f1 = chunk_end(seg_u, seg_v, f0, F, rb, stage_bytes);
      const unsigned char* stage = s_stage + (size_t)(chunk % kStages) * stage_bytes;
      const unsigned char* rows_u = stage - part_begin(seg_u[f0], rb);
      const unsigned char* rows_v =
          stage + part_bytes(seg_u[f0], seg_u[f1], rb) - part_begin(seg_v[f0], rb);
      stage_wait(s_bar + chunk % kStages, (uint32_t)(chunk / kStages) & 1u);
      for (int f = f0; f < f1; ++f) {
        const double* gf = s_g + (size_t)f * TM;
        double df;
        if constexpr (RANK) {
          df = add_rank_rows(0.0, rows_u, gf, seg_u[f] + lane, seg_u[f + 1], cw, c1, shift);
          df = add_rank_rows(df, rows_v, gf, seg_v[f] + lane, seg_v[f + 1], c1, c2, shift);
        } else {
          df = add_slot_rows(0.0, rows_u, gf, seg_u[f] + lane, seg_u[f + 1], codes, pitch,
                             K, rb, shift, a, b);
          df = add_slot_rows(df, rows_v, gf, seg_v[f] + lane, seg_v[f + 1], codes, pitch,
                             K, rb, shift, b, a);
        }
        for (int m = 1; m < lanes; m <<= 1) df += __shfl_xor_sync(mask, df, m);
        const double fn = f_cur[(size_t)f * wpb] + df;
        if ((f & (lanes - 1)) == lane) f_new[(size_t)f * wpb] = fn;
        // the score of fn, feature by feature: the other bodies' score()
        const double x = fabs(__dsub_rn(fn, s_t[f]));
        dsum = __dadd_rn(dsum, __dmul_rn(s_w[f], x));
        group_ok = group_ok && x <= match_tol;
        if (s_last[f]) {
          running = running && group_ok;
          if (running) ell = fmax(ell, s_gd[f]);
          group_ok = true;
        }
      }
      __syncthreads();  // every walker is done with the stage (and fn is written)
      if (tid == 0) ring.issue();
      ++chunk;
      f0 = f1;
    }
    const double d_new = __dsub_rn(dsum, __dmul_rn(match_weight, ell));

    const bool accept = a != b && metropolis(b32, d_new - d_cur, draws.at(i, rng_mode).x);
    if (accept) {
      cur ^= 1;
      d_cur = d_new;
      ++nacc;
    }
    if constexpr (RANK) {
      if (accept) cw = c2;
      if (d_cur < bd) {
        bd = d_cur;
        for (int r = lane; r < R; r += lanes) s_best[r * pitch + wl] = (int8_t)code_of(cw, r);
      }
    } else {
      if (lane == 0) {
        if (accept) {
          *cv = (int8_t)a;
        } else {
          *cu = (int8_t)a;
        }
      }
      __syncwarp(mask);  // the decision's writes, before the copy and the next step
      if (d_cur < bd) {
        bd = d_cur;
        for (int r = lane; r < R; r += lanes) s_best[r * pitch + wl] = codes[r * pitch];
      }
    }
  }

  if constexpr (RANK) {  // the codes back into the block's
    for (int r = lane; r < R; r += lanes) codes[r * pitch] = (int8_t)code_of(cw, r);
  }
  __syncthreads();
  for (int x = tid; x < R * wpb; x += nt) {
    const int r = x / wpb;
    const int c = x % wpb;
    if (w0 + c < W) {
      occ[(size_t)r * W + w0 + c] = s_occ[r * pitch + c];
      best_occ[(size_t)r * W + w0 + c] = s_best[r * pitch + c];
    }
  }
  if (live) {
    const double* f_out = s_f + (size_t)cur * F * wpb + wl;
    for (int k = lane; k < F; k += lanes) feat[(size_t)k * W + w] = f_out[(size_t)k * wpb];
  }
  if (live && lane == 0) {
    dist[w] = d_cur;
    best[w] = bd;
    naccept[w] += nacc;
  }
}

template <bool RANK>
cudaError_t launch_wide(int blocks, int threads, size_t smem, cudaStream_t stream,
                        int8_t* occ, int8_t* best_occ, double* feat, double* dist,
                        double* best, int32_t* naccept, const float* beta,
                        const int32_t* useq, const int32_t* vseq, int seq_stride,
                        int seq_shape_stride, const int64_t* seeds,
                        const unsigned char* rows, const double* gfeat, const int32_t* seg,
                        const double* target, const double* weight,
                        const int32_t* group_last, const double* group_diameter,
                        const double* match, int R, int K, int TM, int F, int W,
                        int block_size, int n_steps, int rng_mode, int lanes,
                        int walkers_per_block, int row_pitch, int stage_bytes) {
  auto kernel = distance_chain_wide_kernel<RANK>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(
      occ, best_occ, feat, dist, best, naccept, beta, useq, vseq, seq_stride,
      seq_shape_stride, seeds, rows, gfeat, seg, target, weight, group_last, group_diameter,
      match, R, K, TM, F, W, block_size, n_steps, rng_mode, lanes, walkers_per_block,
      row_pitch, stage_bytes);
  return cudaGetLastError();
}

// Dynamic shared memory of one launch: the rows (every rank's, or four row
// sets), the segment starts, the codes and the best codes.
size_t shared_bytes(int R, int L, int K, int TM, int F, int walkers_per_block,
                    int resident, int packed) {
  const size_t rb = packed ? RowSets<true>::bytes(L, K, TM) : RowSets<false>::bytes(L, K, TM);
  return (size_t)(resident ? R : 4) * rb + seg_bytes(R, F) +
         2 * (size_t)R * code_pitch(walkers_per_block);
}

template <int KT, int FMAX, bool PACKED, bool ONE_LANE>
cudaError_t launch(int blocks, int threads, size_t smem, cudaStream_t stream,
                   int8_t* occ, int8_t* best_occ, double* feat, double* dist,
                   double* best, int32_t* naccept, const float* beta,
                   const int32_t* useq, const int32_t* vseq, int seq_stride,
                   int seq_shape_stride, const int64_t* seeds, const int32_t* nbr,
                   const int32_t* stride, const int32_t* d2, const double* g,
                   const int32_t* seg, const double* target, const double* weight,
                   const int32_t* group_last, const double* group_diameter,
                   const double* match, const int2* meta, int R, int L, int K, int TM,
                   int F, int W, int block_size, int n_steps, int rng_mode, int lanes,
                   int walkers_per_block, int resident) {
  auto kernel = distance_chain_kernel<KT, FMAX, PACKED, ONE_LANE>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(
      occ, best_occ, feat, dist, best, naccept, beta, useq, vseq, seq_stride,
      seq_shape_stride, seeds, nbr, stride, d2, g, seg, target, weight, group_last,
      group_diameter, match, meta, R, L, K, TM, F, W, block_size, n_steps, rng_mode,
      lanes, walkers_per_block, resident);
  return cudaGetLastError();
}

}  // namespace

extern "C" int smol_distance_chain(
    void* occ, void* best_occ, void* feat, void* dist, void* best, void* naccept,
    const void* beta, const void* useq, const void* vseq, int seq_stride,
    int seq_shape_stride, const void* seeds, const void* nbr, const void* stride,
    const void* d2, const void* g, const void* seg, const void* target,
    const void* weight, const void* group_last, const void* group_diameter,
    const void* match, const void* meta, int S, int R, int L, int K, int TM, int F,
    int W, int block_size, int n_steps, int rng_mode, int lanes, int walkers_per_block,
    int resident, int packed, int wide, int stage_bytes, void* stream) {
  // g: the rows' values [S, R, L, TM], or for the wide body each feature's
  // [S, F, TM]; meta: packed rows [S, R, L, 2] (F <= 8, ops/sqs.py
  // pack_rows), or for the wide body its staged rows [S, R, L, words]
  // int32: rank rows (packed, ops/sqs.py pack_rank_rows) or slot rows
  // (pack_slot_rows), L rows a rank
  const int threads = walkers_per_block * lanes;
  const bool lanes_ok = lanes >= 1 && lanes <= 16 && (lanes & (lanes - 1)) == 0;
  if (F < 1 || (!wide && F > 32) || S < 1 || W < 1 || !lanes_ok ||
      walkers_per_block < 1 || threads > (wide ? kWideThreads : kDistanceThreads) ||
      (W > block_size && block_size % walkers_per_block) ||
      (packed && (meta == nullptr || (!wide && F > 8))) || (wide && resident)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = S * ((W + walkers_per_block - 1) / walkers_per_block);
  if (wide) {  // the rows staged in a ring of shared memory, gf, f and fn too
    const int rb = packed ? 8 : slot_row_bytes(K);
    if (meta == nullptr || (packed && R > 8) || stage_bytes < 16 || stage_bytes % 16 ||
        (L * rb) % 16) {
      return (int)cudaErrorInvalidValue;
    }
    const size_t smem = wide_shared_bytes(R, F, TM, walkers_per_block, stage_bytes);
    auto run = packed ? launch_wide<true> : launch_wide<false>;
    return (int)run(blocks, threads, smem, (cudaStream_t)stream, (int8_t*)occ,
                    (int8_t*)best_occ, (double*)feat, (double*)dist, (double*)best,
                    (int32_t*)naccept, (const float*)beta, (const int32_t*)useq,
                    (const int32_t*)vseq, seq_stride, seq_shape_stride,
                    (const int64_t*)seeds, (const unsigned char*)meta, (const double*)g,
                    (const int32_t*)seg, (const double*)target, (const double*)weight,
                    (const int32_t*)group_last, (const double*)group_diameter,
                    (const double*)match, R, K, TM, F, W, block_size, n_steps, rng_mode,
                    lanes, walkers_per_block, L, stage_bytes);
  }
  const size_t smem = shared_bytes(R, L, K, TM, F, walkers_per_block, resident, packed);
  // the K = 3 bodies packed or not, at one lane or several; the general body
  const bool one = lanes == 1, k3 = K == 3 && F <= 8;
  auto run = packed ? (one ? launch<3, 8, true, true> : launch<3, 8, true, false>)
             : k3   ? (one ? launch<3, 8, false, true> : launch<3, 8, false, false>)
                    : launch<0, 32, false, false>;
  return (int)run(blocks, threads, smem, (cudaStream_t)stream, (int8_t*)occ,
                  (int8_t*)best_occ, (double*)feat, (double*)dist, (double*)best,
                  (int32_t*)naccept, (const float*)beta, (const int32_t*)useq,
                  (const int32_t*)vseq, seq_stride, seq_shape_stride,
                  (const int64_t*)seeds, (const int32_t*)nbr, (const int32_t*)stride,
                  (const int32_t*)d2, (const double*)g, (const int32_t*)seg,
                  (const double*)target, (const double*)weight,
                  (const int32_t*)group_last, (const double*)group_diameter,
                  (const double*)match, (const int2*)meta, R, L, K, TM, F, W, block_size,
                  n_steps, rng_mode, lanes, walkers_per_block, resident);
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// SQS distance-annealing chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of smol_tpu/ops/pallas_sqs.py (make_distance_chain
// :355, `kernel` :394, pallas_call :649): canonical swaps annealed against
// the correlation distance d = -w L + sum_f W_f |f_f - T_f|, each walker
// with its own intensive feature vector f, its score d and its best (score,
// occupancy).  It keeps swap_chain.cu's frame (one thread per walker, the
// block's codes in shared memory for the whole window, exogenous pairs
// (u, v) shared by the walkers of a group, Philox or the reference's hash
// from chain_common.cuh):
//
// - A rank's local rows (one per local cluster and correlation function of
//   its orbit) hold their neighbour ranks and strides, their self stride
//   d2 and their tensor's values corr_flat / fn_cluster_count in f64, and
//   are sorted by feature: rows seg[f] .. seg[f + 1] - 1 feed feature f.
//   Nothing of the TPU layout (bf16 stride planes, the 0/1 scatter matrix
//   on the MXU, extent segments with select loops) is kept: a row's value
//   change is two direct lookups, g[t_new] - g[t_old].
// - The step's feature change df[f] sums, in f64 and in row order, u's rows
//   going a -> b, then v's going b -> a against the occupancy with u
//   already holding b (written into u's shared cell, and a put back on
//   reject), as the reference (:416, :527-537).  F is a template bound
//   FMAX: f and df live in registers, each feature's loop over its rows
//   unrolled over f, so no register array is indexed at run time.  Two
//   bodies: K = 3 with F <= 8 (the bench's FCC triplets, 5 features: 64
//   registers, no spills) and the general one, runtime K with F <= 32.
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
// What bounds it on this card: the latency of each walker's dependent step
// (a step reads 2 x up to L rows of K neighbour codes), not the roofline.
// Both ranks are known in advance, so the next step's rows of u and v are
// copied into shared memory with cp.async, double buffered (K8).  A thread
// beyond the last walker takes part in the copies and the barriers only:
// its whole step lies under one branch.
//
// occ and best_occ ([R, W] int8, rank-major), feat ([F, W] f64), d, best_d
// and naccept are updated in place.  The C entry point returns
// cudaGetLastError() after the launch.

#include "chain_common.cuh"

namespace {

using namespace smol;

// df[f] += the change of each of the rank's rows of feature f (rows
// seg[f] .. seg[f + 1] - 1, in order) going from code a to b.
template <int KT, int FMAX>
__device__ __forceinline__ void add_row_deltas(double (&df)[FMAX], const Rows& rows,
                                               const int32_t* __restrict__ seg,
                                               const int8_t* s_occ, int nt, int tid,
                                               int K_rt, int TM, int F, int a,
                                               int b) {
  const int K = KT > 0 ? KT : K_rt;
  int j = __ldg(seg);
#pragma unroll
  for (int f = 0; f < FMAX; ++f) {
    if (f < F) {
      const int end = __ldg(seg + f + 1);
      double acc = df[f];
      // a feature's row count varies by rank; unrolled, one row's dependent
      // shared loads overlap the next rows' (-19 % per launch, A/B on an H100)
#pragma unroll 4
      for (; j < end; ++j) {
        const int d = rows.d2[j];
        int t = d * a;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int n = rows.nbr[j * K + k];
          const int code = n >= 0 ? (int)s_occ[n * nt + tid] : 0;
          t += rows.st[j * K + k] * code;
        }
        const int tn = t + d * (b - a);
        const double term = rows.g[j * TM + tn] - rows.g[j * TM + t];
        acc += term;
      }
      df[f] = acc;
    }
  }
}

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

template <int KT, int FMAX>
__global__ void __launch_bounds__(kMaxThreads)
distance_chain_kernel(int8_t* __restrict__ occ, int8_t* __restrict__ best_occ,
                      double* __restrict__ feat, double* __restrict__ dist,
                      double* __restrict__ best, int32_t* __restrict__ naccept,
                      const float* __restrict__ beta,
                      const int32_t* __restrict__ useq,
                      const int32_t* __restrict__ vseq, int seq_stride,
                      const int64_t* __restrict__ seed_ptr,
                      const int32_t* __restrict__ nbr,
                      const int32_t* __restrict__ stride,
                      const int32_t* __restrict__ d2,
                      const double* __restrict__ g,
                      const int32_t* __restrict__ seg,
                      const double* __restrict__ target,
                      const double* __restrict__ weight,
                      const int32_t* __restrict__ group_last,
                      const double* __restrict__ group_diameter, int R, int L,
                      int K_rt, int TM, int F, int W, int block_size, int n_steps,
                      int rng_mode, double match_tol, double match_weight) {
  const int K = KT > 0 ? KT : K_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_t[FMAX], s_w[FMAX], s_gd[FMAX];
  __shared__ int s_last[FMAX];
  // two slots (this step, next step), each the rows of u then of v
  const size_t rb = rows_bytes(L, K, TM, 0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int8_t* s_occ = reinterpret_cast<int8_t*>(smem + 4 * rb);
  int8_t* s_best = s_occ + (size_t)R * nt;

  const int w = blockIdx.x * nt + tid;
  const bool live = w < W;
  const int wc = live ? w : W - 1;

  for (int f = tid; f < F; f += nt) {
    s_t[f] = target[f];
    s_w[f] = weight[f];
    s_gd[f] = group_diameter[f];
    s_last[f] = group_last[f];
  }
  for (int r = 0; r < R; ++r) {
    s_occ[r * nt + tid] = occ[(size_t)r * W + wc];
    s_best[r * nt + tid] = best_occ[(size_t)r * W + wc];
  }
  double cur[FMAX];  // the walker's features
#pragma unroll
  for (int k = 0; k < FMAX; ++k) cur[k] = k < F ? feat[(size_t)k * W + wc] : 0.0;
  double d_cur = dist[wc];
  double bd = best[wc];
  const float b32 = beta[wc];
  int nacc = 0;

  // the whole CUDA block lies in one sequence group (see the launcher)
  const int grp = (blockIdx.x * nt) / block_size;
  const int32_t* my_useq = useq + (size_t)grp * seq_stride;
  const int32_t* my_vseq = vseq + (size_t)grp * seq_stride;
  const Draws draws(*seed_ptr, grp, wc, block_size);

  auto prefetch = [&](int i) {  // step i's rows of u and v into slot i & 1
    unsigned char* slot = smem + (i & 1) * 2 * rb;
    copy_rows(rows_at(slot, L, K, TM, 0), __ldg(my_useq + i), nbr, stride, d2, g,
              nullptr, L, K, TM, 0, tid, nt);
    copy_rows(rows_at(slot + rb, L, K, TM, 0), __ldg(my_vseq + i), nbr, stride, d2,
              g, nullptr, L, K, TM, 0, tid, nt);
  };
  if (n_steps > 0) prefetch(0);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    unsigned char* slot = smem + (i & 1) * 2 * rb;
    const Rows ru = rows_at(slot, L, K, TM, 0);
    const Rows rv = rows_at(slot + rb, L, K, TM, 0);
    if (i + 1 < n_steps) prefetch(i + 1);

    if (live) {
      const int u = __ldg(my_useq + i);
      const int v = __ldg(my_vseq + i);
      int8_t* cu = s_occ + u * nt + tid;
      int8_t* cv = s_occ + v * nt + tid;
      const int a = *cu;
      const int b = *cv;

      double df[FMAX];
#pragma unroll
      for (int k = 0; k < FMAX; ++k) df[k] = 0.0;
      add_row_deltas<KT, FMAX>(df, ru, seg + u * (F + 1), s_occ, nt, tid, K, TM, F,
                               a, b);
      *cu = (int8_t)b;  // v's rows see u already holding b
      add_row_deltas<KT, FMAX>(df, rv, seg + v * (F + 1), s_occ, nt, tid, K, TM, F,
                               b, a);
      double fn[FMAX];
#pragma unroll
      for (int k = 0; k < FMAX; ++k) fn[k] = cur[k] + df[k];
      const double d_new = score<FMAX>(fn, s_t, s_w, s_last, s_gd, F, match_tol,
                                       match_weight);

      if (a != b && metropolis(b32, d_new - d_cur, draws.at(i, rng_mode).x)) {
        *cv = (int8_t)a;
#pragma unroll
        for (int k = 0; k < FMAX; ++k) cur[k] = fn[k];
        d_cur = d_new;
        ++nacc;
      } else {
        *cu = (int8_t)a;
      }
      if (d_cur < bd) {
        bd = d_cur;
        for (int r = 0; r < R; ++r) s_best[r * nt + tid] = s_occ[r * nt + tid];
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  if (live) {
    for (int r = 0; r < R; ++r) {
      occ[(size_t)r * W + w] = s_occ[r * nt + tid];
      best_occ[(size_t)r * W + w] = s_best[r * nt + tid];
    }
#pragma unroll
    for (int k = 0; k < FMAX; ++k) {
      if (k < F) feat[(size_t)k * W + w] = cur[k];
    }
    dist[w] = d_cur;
    best[w] = bd;
    naccept[w] += nacc;
  }
}

template <int KT, int FMAX>
cudaError_t launch(int threads, size_t smem, cudaStream_t stream, int8_t* occ,
                   int8_t* best_occ, double* feat, double* dist, double* best,
                   int32_t* naccept, const float* beta, const int32_t* useq,
                   const int32_t* vseq, int seq_stride, const int64_t* seed,
                   const int32_t* nbr, const int32_t* stride, const int32_t* d2,
                   const double* g, const int32_t* seg, const double* target,
                   const double* weight, const int32_t* group_last,
                   const double* group_diameter, int R, int L, int K, int TM, int F,
                   int W, int block_size, int n_steps, int rng_mode,
                   double match_tol, double match_weight) {
  auto kernel = distance_chain_kernel<KT, FMAX>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (W + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(
      occ, best_occ, feat, dist, best, naccept, beta, useq, vseq, seq_stride, seed,
      nbr, stride, d2, g, seg, target, weight, group_last, group_diameter, R, L, K,
      TM, F, W, block_size, n_steps, rng_mode, match_tol, match_weight);
  return cudaGetLastError();
}

}  // namespace

extern "C" int smol_distance_chain(
    void* occ, void* best_occ, void* feat, void* dist, void* best, void* naccept,
    const void* beta, const void* useq, const void* vseq, int seq_stride,
    const void* seed, const void* nbr, const void* stride, const void* d2,
    const void* g, const void* seg, const void* target, const void* weight,
    const void* group_last, const void* group_diameter, int R, int L, int K, int TM,
    int F, int W, int block_size, int n_steps, int rng_mode, double match_tol,
    double match_weight, void* stream) {
  if (F < 1 || F > 32) return (int)cudaErrorInvalidValue;
  const int threads = block_threads(W, block_size);
  const size_t smem = 4 * rows_bytes(L, K, TM, 0) + 2 * (size_t)R * threads;
  auto run = (K == 3 && F <= 8) ? launch<3, 8> : launch<0, 32>;
  return (int)run(threads, smem, (cudaStream_t)stream, (int8_t*)occ,
                  (int8_t*)best_occ, (double*)feat, (double*)dist, (double*)best,
                  (int32_t*)naccept, (const float*)beta, (const int32_t*)useq,
                  (const int32_t*)vseq, seq_stride, (const int64_t*)seed,
                  (const int32_t*)nbr, (const int32_t*)stride, (const int32_t*)d2,
                  (const double*)g, (const int32_t*)seg, (const double*)target,
                  (const double*)weight, (const int32_t*)group_last,
                  (const double*)group_diameter, R, L, K, TM, F, W, block_size,
                  n_steps, rng_mode, match_tol, match_weight);
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

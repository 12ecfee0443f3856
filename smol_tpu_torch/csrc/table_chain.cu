// Shared-proposal table-move Metropolis chain for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU chain kernel of smol_tpu/ops/pallas_chain.py
// (make_shared_proposal_chain, move="table": `table_step` :1701-1785 with
// its site delta, the Ewald term ewald_delta (K4), the chemical work
// mu_work and the accept), the constrained-composition moves of a TableFlip
// usher, e.g. charge-neutral semigrand sampling where Li+ enters or leaves
// only together with Mn4+ <-> Mn3+.  It keeps flip_chain.cu's frame (one
// thread per walker, the block's codes in shared memory for the whole
// window, Philox or the reference's hash):
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
//   taken against the occupancy as slots 0 .. j-1 left it (b_j is written
//   into the slot's shared cell once its delta is known): its clusters'
//   terms in order l = 0, 1, ..., then its Ewald term (b_j - a0[j]) *
//   (C_r + V_r . occ), then minus its chemical work mu[r, b_j] - mu[r,
//   a0[j]].  All in native f64 and in that order, as the plain torch twin
//   in ops/chain.py sums (the reference adds double-float f32 pairs and
//   takes the Ewald dot in f32).  Slots that are not valid contribute
//   exactly zero in the reference and are skipped here; only valid slots'
//   sites are known to be distinct.
// - Plain Metropolis on -beta * dH with the f32 exponent and the step's one
//   uniform (slot 1 of the hash, word x of Philox): the proposal is
//   symmetric, so no a-priori factor.  On reject the slots take a0 back.
//
// What bounds it on this card: as for the other chains, the latency of
// each walker's dependent step, not the roofline.  A valid move does the
// work of one flip per valid slot; most proposals of a charge-neutral
// system are identities (the drawn sites rarely hold the from-codes), and
// a warp is as slow as its slowest walker, so a step costs about a valid
// move wherever any of the warp's 32 walkers has one.  Direction and
// ranks are known in advance, so the rows (nbr, stride, d2, g, Ewald row)
// of the next step's valid slots are copied into shared memory with
// cp.async, double buffered: two buffers of KM row sets.
//
// KMT is the slot count as a compile-time constant: 2 for one flip vector
// of two recolorings plus the swap row (the spinel), 0 for a runtime count
// up to 8, as KT is for the clusters' slot count K.
//
// The occupancy ([R, W] int8 codes, rank-major), enthalpy and accept counts
// are updated in place.  The C entry point returns cudaGetLastError() after
// the launch.

#include "chain_common.cuh"

namespace {

using namespace smol;

constexpr int kMaxTableSlots = 8;

// KT: the clusters' slot count K as a compile-time constant (0: runtime K);
// KMT: the table move's slot count (0: runtime, at most kMaxTableSlots);
// EW: the tables carry the Ewald fold (ew_v [R, R], ew_c [R]).
template <int KT, int KMT, bool EW>
__global__ void __launch_bounds__(kMaxThreads)
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
                   const double* __restrict__ ew_c, int R, int L, int K_rt,
                   int TM, int C, int W, int block_size, int n_steps,
                   int rng_mode, int km_rt, int n_rows) {
  const int K = KT > 0 ? KT : K_rt;
  const int KM = KMT > 0 ? KMT : km_rt;
  constexpr int kSlots = KMT > 0 ? KMT : kMaxTableSlots;
  const int RE = EW ? R : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  // two buffers (this step, next step) of KM row sets, then the codes
  const size_t rb = rows_bytes(L, K, TM, RE);
  int8_t* s_occ = reinterpret_cast<int8_t*>(smem + 2 * KM * rb);

  // the move table [3, n_rows, KM]: from-code, to-code, slot valid
  const int32_t* from_code = move_rows;
  const int32_t* to_code = move_rows + n_rows * KM;
  const int32_t* slot_valid = move_rows + 2 * n_rows * KM;

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
  const int32_t* my_dirs = dirs + (size_t)grp * dir_stride;
  const int32_t* my_ranks = ranks + (size_t)grp * rank_stride;
  const Draws draws(*seed_ptr, grp, wc, block_size);

  auto prefetch = [&](int i) {  // step i's valid slots' rows into buffer i & 1
    unsigned char* buf = smem + (i & 1) * KM * rb;
    const int d = __ldg(my_dirs + i);
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (__ldg(slot_valid + d * KM + j) > 0) {
        copy_rows(rows_at(buf + j * rb, L, K, TM, RE),
                  __ldg(my_ranks + (size_t)i * KM + j), nbr, stride, d2, g,
                  ew_v, L, K, TM, RE, tid, nt);
      }
    }
  };
  if (n_steps > 0) prefetch(0);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    unsigned char* buf = smem + (i & 1) * KM * rb;
    if (i + 1 < n_steps) prefetch(i + 1);

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
      a0[j] = s_occ[__ldg(rk + j) * nt + tid];
      const int from = __ldg(fc + j);
      const bool need = __ldg(sv + j) > 0 && from >= 0;
      valid = valid && (!need || a0[j] == from);
    }
    if (__ldg(tc) == -2) valid = valid && a0[0] != a0[1];  // the swap row

    if (valid) {
      double dE = 0.0;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (__ldg(sv + j) > 0) {
          const int r = __ldg(rk + j);
          const int to = __ldg(tc + j);
          const int a = a0[j];
          const int b = to >= 0 ? to : a0[j ^ 1];  // -2: the partner's code
          const Rows rows = rows_at(buf + j * rb, L, K, TM, RE);
          // the Ewald term is taken first and added after the cluster terms:
          // the same sum in the same order, but with the dot issued first a
          // window ran a fifth faster on an H100 (swap_chain.cu does the same)
          double ewald = 0.0;
          if (EW) ewald = ewald_term(rows.ew, __ldg(ew_c + r), s_occ, nt, tid, R, b - a);
          dE = ce_add<KT>(dE, rows, s_occ, nt, tid, L, K, TM, a, b);
          if (EW) dE += ewald;
          const double work = __ldg(mu + r * C + b) - __ldg(mu + r * C + a);
          dE -= work;
          s_occ[r * nt + tid] = (int8_t)b;  // the next slot sees this one applied
        }
      }
      if (metropolis(b32, dE, draws.at(i, rng_mode).x)) {
        e += dE;
        ++nacc;
      } else {
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (__ldg(sv + j) > 0) s_occ[__ldg(rk + j) * nt + tid] = (int8_t)a0[j];
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
  }
}

template <int KT, int KMT>
auto pick_ewald(bool ew) {
  return ew ? table_chain_kernel<KT, KMT, true> : table_chain_kernel<KT, KMT, false>;
}

}  // namespace

extern "C" int smol_table_chain(void* occ, void* enthalpy, void* naccept,
                                const void* beta, const void* dirs,
                                const void* ranks, int dir_stride,
                                int rank_stride, const void* seed,
                                const void* nbr, const void* stride,
                                const void* d2, const void* g, const void* mu,
                                const void* move_rows, const void* ew_v,
                                const void* ew_c, int R, int L, int K, int TM,
                                int C, int W, int block_size, int n_steps,
                                int rng_mode, int k_max, int n_rows,
                                void* stream) {
  if (k_max < 2 || k_max > kMaxTableSlots) return (int)cudaErrorInvalidValue;
  const int threads = block_threads(W, block_size);
  const bool ew = ew_v != nullptr;
  const size_t smem =
      2 * (size_t)k_max * rows_bytes(L, K, TM, ew ? R : 0) + (size_t)R * threads;
  auto kernel = k_max == 2
                    ? (K == 3 ? pick_ewald<3, 2>(ew) : pick_ewald<0, 2>(ew))
                    : (K == 3 ? pick_ewald<3, 0>(ew) : pick_ewald<0, 0>(ew));
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (W + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (int8_t*)occ, (double*)enthalpy, (int32_t*)naccept, (const float*)beta,
      (const int32_t*)dirs, (const int32_t*)ranks, dir_stride, rank_stride,
      (const int64_t*)seed, (const int32_t*)nbr, (const int32_t*)stride,
      (const int32_t*)d2, (const double*)g, (const double*)mu,
      (const int32_t*)move_rows, (const double*)ew_v, (const double*)ew_c, R,
      L, K, TM, C, W, block_size, n_steps, rng_mode, k_max, n_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* smol_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Pieces shared by the chain kernels flip_chain.cu, swap_chain.cu,
// table_chain.cu, wl_chain.cu and distance_chain.cu, and by the exchange
// kernel tempering.cu.
//
// - the random bits: the reference's interpret-mode hash, bit for bit, and
//   Philox4x32-10 (replacing the TPU hardware PRNG of smol_tpu/ops/prims.py);
// - the replica-exchange decision of a pair (exchange_accept);
// - one rank's table rows in shared memory and their cp.async prefetch
//   (the analog of the reference's streamed-table DMA, pallas_chain.py
//   :1590-1626);
// - the cluster-expansion delta of one site, in one of three bodies: Direct
//   (one f64 lookup per local cluster, summed in the order l = 0, 1, ...),
//   Qary, K3, the Z_q character delta of pallas_chain.py
//   `make_site_delta_qary` (:519) and `make_swap_pair_delta_qary` (:570),
//   summed in row order, and Ising, K1-Ising, the parity delta of
//   `make_site_delta_ising` (:374) and `make_swap_pair_delta_ising` (:410),
//   with the walker's codes as rank bits in registers, summed in row order;
// - K4, the Ewald term sign * (C_r + V_r . occ) of pallas_chain.py
//   `ewald_delta` (:1651), in f64 over the block's codes in rank order
//   (ewald_term), or split over a walker's lanes (lane_ewald_term);
// - lanes: a walker as G consecutive threads of one warp, each summing
//   every G-th of a rank's rows, the partials meeting in a butterfly of
//   shuffles (Lanes<Body>, lane_sum), and the whole delta of a flip
//   (lane_flip_delta: the flip and Wang-Landau chains) and of a swap
//   (lane_swap_delta: the swap and Wang-Landau chains); the table chain
//   calls Lanes<Body> itself, slot by slot;
// - the frame of those four chains: a thread's walker and lane, the
//   block's codes loaded and stored (LaneFrame), the split draw of log U
//   (lane_log_u) and the launch shapes they take (lane_launch_ok).
//
// Every body's rows carry the rank's Ewald row (ew, RE doubles: R with an
// Ewald term, else none), so K4 goes with each of them.
//
// The plain torch twins in ops/chain.py sum in the same orders, so kernel
// and twin give the same f64 deltas.  Build without fast-math: nothing may
// reorder these sums.

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace smol {

constexpr int kRngPhilox = 0;
constexpr int kRngHash = 1;

__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t step,
                                              uint32_t slot, uint32_t lane) {
  // murmur3-finalizer hash of smol_tpu/ops/pallas_chain.py _hash_uniform01
  // (int32 wrapping products and logical shifts == uint32 arithmetic)
  uint32_t x = lane + seed * (2654435761u & 0x7FFFFFFFu);
  x ^= step * 40503u + slot * (2246822519u & 0x7FFFFFFFu);
  x ^= x >> 13;
  x *= 0x85EBCA6Bu;                            // -2048144789 as uint32
  x ^= x >> 16;
  x *= 0xC2B2AE35u;                            // -1028477387 as uint32
  x ^= x >> 16;
  return x & 0x7FFFFFFFu;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The random bits of one walker's chain launch.
struct Draws {
  uint32_t block_seed;  // hash mode: seed_chunk + group * 7919 (int32 wrap)
  uint32_t lane;        // hash mode: walker index within its group
  uint2 key;            // philox: (seed low word, walker)
  uint32_t seed_hi;     // philox: counter word 1

  __device__ Draws(int64_t seed, int grp, int wc, int block_size)
      : block_seed((uint32_t)seed + (uint32_t)grp * 7919u),
        lane((uint32_t)(wc % block_size)),
        key(make_uint2((uint32_t)((uint64_t)seed & 0xFFFFFFFFu), (uint32_t)wc)),
        seed_hi((uint32_t)((uint64_t)seed >> 32)) {}

  // (r_u, r_j) of step i: the acceptance bits and the proposed-code bits
  __device__ __forceinline__ uint2 at(int i, int rng_mode) const {
    if (rng_mode == kRngHash) {
      return make_uint2(hash_bits(block_seed, (uint32_t)i, 1u, lane),
                        hash_bits(block_seed, (uint32_t)i, 0u, lane));
    }
    const uint4 x = philox4x32_10(make_uint4((uint32_t)i, seed_hi, 0u, 0u), key);
    return make_uint2(x.x & 0x7FFFFFFFu, x.y & 0x7FFFFFFFu);
  }
};

// log U in f32, U in (0, 1] from the 31 random bits r_u, as the reference
// takes it (:1879).
__device__ __forceinline__ float log_uniform(uint32_t r_u) {
  return logf(((float)(r_u >> 7) + 1.0f) * 5.9604644775390625e-8f);
}

// Accept on an f32 exponent: expo >= 0 or expo > log U (:1883).
__device__ __forceinline__ bool accept_exponent(float expo, uint32_t r_u) {
  return expo >= 0.0f || expo > log_uniform(r_u);
}

// The Metropolis decision in f32, as the reference takes it (:1882).
__device__ __forceinline__ bool metropolis(float beta, double dE, uint32_t r_u) {
  return accept_exponent(-beta * (float)dE, r_u);
}

// The replica-exchange decision of the pair (l, l + 1), as the reference
// takes it at the left member (smol_tpu/parallel/tempering.py:42): with d =
// (beta_l - beta_r) (H_l - H_r) in f64, exchange if d >= 0 or d > log u_l.
// The product of two differences forms no fused multiply-add, so both
// members of a pair, each calling this on the same four values and u_l,
// reach the same bits (tempering.cu, and the windowed flip chain).
__device__ __forceinline__ bool exchange_accept(double beta_l, double beta_r,
                                                double h_l, double h_r, double u_l) {
  const double d = (beta_l - beta_r) * (h_l - h_r);
  return d >= 0.0 || d > log(u_l);
}

struct Rows {  // one rank's table rows in shared memory
  double* g;      // [L, TM]
  double* ew;     // [RE] Ewald row V_r (RE = R with an Ewald term, else 0)
  int32_t* nbr;   // [L, K]
  int32_t* st;    // [L, K]
  int32_t* d2;    // [L]
};

__host__ __device__ __forceinline__ size_t rows_bytes(int L, int K, int TM,
                                                      int RE) {
  const size_t bytes =
      (size_t)L * TM * 8 + (size_t)RE * 8 + (size_t)L * (2 * K + 1) * 4;
  return (bytes + 15) / 16 * 16;  // keeps the next buffer's g aligned
}

__device__ __forceinline__ Rows rows_at(unsigned char* base, int L, int K,
                                        int TM, int RE) {
  Rows r;
  r.g = reinterpret_cast<double*>(base);
  r.ew = r.g + (size_t)L * TM;
  r.nbr = reinterpret_cast<int32_t*>(r.ew + RE);
  r.st = r.nbr + L * K;
  r.d2 = r.st + L * K;
  return r;
}

// Issue the asynchronous copy of rank u's rows into `dst` (all threads).
__device__ __forceinline__ void copy_rows(const Rows& dst, int u,
                                          const int32_t* __restrict__ nbr,
                                          const int32_t* __restrict__ stride,
                                          const int32_t* __restrict__ d2,
                                          const double* __restrict__ g,
                                          const double* __restrict__ ew_v,
                                          int L, int K, int TM, int RE,
                                          int tid, int nt) {
  const double* g_u = g + (size_t)u * L * TM;
  for (int x = tid; x < L * TM; x += nt) {
    __pipeline_memcpy_async(dst.g + x, g_u + x, sizeof(double));
  }
  const double* ew_u = ew_v + (size_t)u * RE;
  for (int x = tid; x < RE; x += nt) {
    __pipeline_memcpy_async(dst.ew + x, ew_u + x, sizeof(double));
  }
  const int32_t* nb_u = nbr + (size_t)u * L * K;
  const int32_t* st_u = stride + (size_t)u * L * K;
  for (int x = tid; x < L * K; x += nt) {
    __pipeline_memcpy_async(dst.nbr + x, nb_u + x, sizeof(int32_t));
    __pipeline_memcpy_async(dst.st + x, st_u + x, sizeof(int32_t));
  }
  const int32_t* d2_u = d2 + (size_t)u * L;
  for (int x = tid; x < L; x += nt) {
    __pipeline_memcpy_async(dst.d2 + x, d2_u + x, sizeof(int32_t));
  }
  __pipeline_commit();
}

// K3's character rows of one rank in shared memory (ops/chain.py
// qary_tables): row l is the character sum_k freq[l, k] code(nbr[l, k]) +
// ms[l] code(self) (mod Q) with folded amplitudes ac[l], as[l]; and, with
// an Ewald term (binary sites: Q = 2), the Ewald row.
struct QRows {
  double* ac;     // [Lq]
  double* as;     // [Lq]
  double* ew;     // [RE] Ewald row V_r (RE = R with an Ewald term, else 0)
  int32_t* nbr;   // [Lq, NB] neighbour rank, -1 = none
  int32_t* freq;  // [Lq, NB] scaled frequency in [0, Q)
  int32_t* ms;    // [Lq] scaled self frequency in [1, Q)
};

__host__ __device__ __forceinline__ size_t qrows_bytes(int Lq, int NB, int RE) {
  const size_t bytes =
      (size_t)Lq * 16 + (size_t)RE * 8 + (size_t)Lq * (2 * NB + 1) * 4;
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ QRows qrows_at(unsigned char* base, int Lq, int NB,
                                          int RE) {
  QRows r;
  r.ac = reinterpret_cast<double*>(base);
  r.as = r.ac + Lq;
  r.ew = r.as + Lq;
  r.nbr = reinterpret_cast<int32_t*>(r.ew + RE);
  r.freq = r.nbr + Lq * NB;
  r.ms = r.freq + Lq * NB;
  return r;
}

// The per-walker state a body keeps in registers beside the block's codes:
// none for the direct and the q-ary bodies.
struct NoWalker {
  __device__ void load(const int8_t*, int, int, int) {}
  __device__ void set(int, int) {}
};

// The table operands of the flip and swap chains, passed by value.
struct Tables {
  // the direct body: [R, L, K], [R, L, K], [R, L], [R, L, TM]
  const int32_t* nbr;
  const int32_t* stride;
  const int32_t* d2;
  const double* g;
  const double* ew_v;  // [R, RE] Ewald rows, RE = R with an Ewald term
  // K3: [R, Lq, NB], [R, Lq, NB], [R, Lq], [R, Lq], [R, Lq], [R]
  const int32_t* qnbr;
  const int32_t* qfreq;
  const int32_t* qms;
  const double* qac;
  const double* qas;
  const int32_t* qrows;
  int L, K, TM, RE, Lq, NB;
  // K1-Ising: [R, Li, NW] rank-bit masks, [R, Li] amplitudes, [R] row counts
  const uint64_t* imask;
  const double* iamp;
  const int32_t* irows;
  int Li, NW;
};

// The direct body: one rank's local-cluster rows (Rows); a rank going
// from code a to b changes each local cluster l by g[l, t + d2 (b - a)] -
// g[l, t], t = d2 * a + sum_k stride * code(nbr) (Lanes<Direct>).  KT > 0:
// the slot count K as a compile-time constant; KT == 0: runtime K.  On an
// H100 a runtime K ran 2.8x slower per step than the constant on the
// spinel (K = 3), so K = 3 has its own instantiations.
template <int KT>
struct Direct {
  using Rows = smol::Rows;
  using Walker = NoWalker;
  // the slot count as a compile-time constant where the body has one
  __device__ static void pin(Tables& t) {
    if constexpr (KT > 0) t.K = KT;
  }
  __host__ __device__ static size_t bytes(const Tables& t) {
    return rows_bytes(t.L, t.K, t.TM, t.RE);
  }
  __device__ static Rows at(unsigned char* base, const Tables& t) {
    return rows_at(base, t.L, t.K, t.TM, t.RE);
  }
  __device__ static void copy(unsigned char* dst, int u, const Tables& t,
                              int tid, int nt) {
    copy_rows(at(dst, t), u, t.nbr, t.stride, t.d2, t.g, t.ew_v, t.L, t.K,
              t.TM, t.RE, tid, nt);
  }
};

// K3's folded phase selectors, pallas_chain.py `_phase_sel` (:476): cos and
// sin of 2 pi w / Q over their folds (ops/chain.py QARY_SIGMA).
template <int Q>
__device__ __forceinline__ int sigma_c(int w) {
  if constexpr (Q == 2) return 1 - 2 * w;
  if constexpr (Q == 4) return (w == 0 ? 1 : 0) - (w == 2 ? 1 : 0);
  return w == 0 ? 1 : 0;
}

template <int Q>
__device__ __forceinline__ int sigma_s(int w) {
  if constexpr (Q == 2) return 0;
  if constexpr (Q == 4) return (w == 1 ? 1 : 0) - (w == 3 ? 1 : 0);
  return (w == 1 ? 1 : 0) - (w == 2 ? 1 : 0);
}

// The q-ary body: a rank's qrows[u] character rows (QRows).  A rank going
// a -> b changes row l by ac dc + as ds: the neighbour phase u = sum_k freq
// * code(nbr) is an integer >= 0, the phases (u + ms a) mod Q and (u + ms
// b) mod Q, and dc, ds in {0, +-1, +-2}: both products are exact, so
// whether nvcc contracts the sum into an FMA or not, it rounds once, as the
// twin's does (Q = 2 has no sin characters; Lanes<Qary>).  NBT > 0: the
// neighbours per row as a compile-time constant.
template <int Q, int NBT>
struct Qary {
  using Rows = QRows;
  using Walker = NoWalker;
  // the neighbour count as a compile-time constant where the body has one
  __device__ static void pin(Tables& t) {
    if constexpr (NBT > 0) t.NB = NBT;
  }
  __host__ __device__ static size_t bytes(const Tables& t) {
    return qrows_bytes(t.Lq, t.NB, t.RE);
  }
  __device__ static Rows at(unsigned char* base, const Tables& t) {
    return qrows_at(base, t.Lq, t.NB, t.RE);
  }
  // Issue the asynchronous copy of rank u's rows into `dst` (all threads).
  __device__ static void copy(unsigned char* dst, int u, const Tables& t,
                              int tid, int nt) {
    const QRows r = at(dst, t);
    const int n = __ldg(t.qrows + u);
    const size_t row0 = (size_t)u * t.Lq;
    for (int x = tid; x < n; x += nt) {
      __pipeline_memcpy_async(r.ac + x, t.qac + row0 + x, sizeof(double));
      __pipeline_memcpy_async(r.as + x, t.qas + row0 + x, sizeof(double));
      __pipeline_memcpy_async(r.ms + x, t.qms + row0 + x, sizeof(int32_t));
    }
    for (int x = tid; x < n * t.NB; x += nt) {
      __pipeline_memcpy_async(r.nbr + x, t.qnbr + row0 * t.NB + x,
                              sizeof(int32_t));
      __pipeline_memcpy_async(r.freq + x, t.qfreq + row0 * t.NB + x,
                              sizeof(int32_t));
    }
    const double* ew_u = t.ew_v + (size_t)u * t.RE;
    for (int x = tid; x < t.RE; x += nt) {
      __pipeline_memcpy_async(r.ew + x, ew_u + x, sizeof(double));
    }
    __pipeline_commit();
  }
};

// K1-Ising's rows of one rank in shared memory (ops/chain.py ising_tables,
// the rows of nonzero amplitude in local-cluster order): row l's amplitude
// amp[l] and its neighbour-membership mask mask[l * NW .. l * NW + NW) of
// rank bits, and, with an Ewald term, the Ewald row.
struct IRows {
  double* amp;     // [Li]
  double* ew;      // [RE] Ewald row V_r (RE = R with an Ewald term, else 0)
  uint64_t* mask;  // [Li, NW]
};

__host__ __device__ __forceinline__ size_t irows_bytes(int Li, int NW, int RE) {
  const size_t bytes = ((size_t)Li * (NW + 1) + (size_t)RE) * 8;
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ IRows irows_at(unsigned char* base, int Li, int NW,
                                          int RE) {
  IRows r;
  r.amp = reinterpret_cast<double*>(base);
  r.ew = r.amp + Li;
  r.mask = reinterpret_cast<uint64_t*>(r.ew + RE);
  return r;
}

// The walker's binary codes as NW words of rank bits (rank r is bit r % 64
// of word r / 64), held in registers: every index into w is a compile-time
// constant once the loops over k are unrolled.
template <int NW>
struct Bits {
  uint64_t w[NW];

  __device__ __forceinline__ void load(const int8_t* s_occ, int R, int nt,
                                       int tid) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint64_t x = 0;
      for (int j = 0; j < 64 && 64 * k + j < R; ++j) {
        x |= (uint64_t)(s_occ[(64 * k + j) * nt + tid] != 0) << j;
      }
      w[k] = x;
    }
  }

  __device__ __forceinline__ void set(int r, int code) {
    const uint64_t m = 1ull << (r & 63);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if ((r >> 6) == k) w[k] = code ? (w[k] | m) : (w[k] & ~m);
    }
  }
};

// One parity row's signed amplitude: A (-1)^t, t = popc(mask & bits).  The
// parity of a sum of popcounts is that of the popcount of the xor of the
// words, folded to 32 bits; the sign is set by an xor into A's high word,
// which is -A exactly (as the twin's torch.where(odd, -amp, amp)).
template <int NW>
__device__ __forceinline__ double ising_term(const uint64_t (&mask)[NW], double A,
                                             const Bits<NW>& bits) {
  uint64_t x = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) x ^= mask[k] & bits.w[k];
  const unsigned odd = (unsigned)__popc((unsigned)x ^ (unsigned)(x >> 32)) << 31;
  return __hiloint2double(__double2hiint(A) ^ (int)odd, __double2loint(A));
}

// The Ising body: a rank's irows[u] parity rows (IRows) and the walker's
// codes as bits (Bits<NW>).  A rank going a -> b changes the energy by
// -2 (b - a) S, S = sum over rows l of A_l (-1)^{t_l} (Lanes<Ising>).  NW,
// the words of rank bits (1 to 4: up to 256 ranks), is a compile-time
// constant.
template <int NW>
struct Ising {
  using Rows = IRows;
  using Walker = Bits<NW>;
  __device__ static void pin(Tables& t) { t.NW = NW; }
  __host__ __device__ static size_t bytes(const Tables& t) {
    return irows_bytes(t.Li, t.NW, t.RE);
  }
  __device__ static Rows at(unsigned char* base, const Tables& t) {
    return irows_at(base, t.Li, t.NW, t.RE);
  }
  // Issue the asynchronous copy of rank u's rows into `dst` (all threads).
  __device__ static void copy(unsigned char* dst, int u, const Tables& t,
                              int tid, int nt) {
    const IRows r = at(dst, t);
    const int n = __ldg(t.irows + u);
    const size_t row0 = (size_t)u * t.Li;
    for (int x = tid; x < n; x += nt) {
      __pipeline_memcpy_async(r.amp + x, t.iamp + row0 + x, sizeof(double));
    }
    for (int x = tid; x < n * NW; x += nt) {
      __pipeline_memcpy_async(r.mask + x, t.imask + row0 * NW + x,
                              sizeof(uint64_t));
    }
    const double* ew_u = t.ew_v + (size_t)u * t.RE;
    for (int x = tid; x < t.RE; x += nt) {
      __pipeline_memcpy_async(r.ew + x, ew_u + x, sizeof(double));
    }
    __pipeline_commit();
  }
};

// K4: sign * (C_r + V_r . occ) with the dot over the walker's codes in rank
// order t = 0 .. R-1.  Ewald systems have 0/1 codes, so every product is
// exact and the sum rounds as the twin's rank-order loop does.
__device__ __forceinline__ double ewald_term(const double* row, double c,
                                             const int8_t* s_occ, int nt,
                                             int tid, int R, int sign) {
  double acc = 0.0;
#pragma unroll 8
  for (int t = 0; t < R; ++t) {
    acc += row[t] * (double)s_occ[t * nt + tid];
  }
  return (double)sign * (c + acc);
}

// ---- lanes: a walker as G consecutive threads of one warp (G = 1, 2, 4, 8
// or 16), the block's codes [R][code_pitch] in shared memory, one byte a
// walker (every chain of this header) ----

constexpr int kLaneBatch = 8;  // parity rows a lane loads before it sums them

// Bytes of one rank-major row of the block's codes: one per walker, padded
// so that the rows of different ranks start in different banks.
__host__ __device__ __forceinline__ int code_pitch(int walkers_per_block) {
  return (walkers_per_block + 3) / 4 * 4 + 4;
}

__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// The lanes' partials meet: every lane ends with the sum, bit for bit the
// same (f64 addition commutes).
template <typename T>
__device__ __forceinline__ T lane_sum(T x, unsigned mask, int lanes) {
  for (int m = 1; m < lanes; m <<= 1) x += __shfl_xor_sync(mask, x, m);
  return x;
}

// A thread's place in the block of a lane kernel (the flip, swap, table
// and Wang-Landau chains): walker `wl` of the block's `wpb`, lane `lane`
// of its `lanes`, and the block's codes of the occupancy ([R, W] int8,
// rank-major) in shared memory [R][code_pitch(wpb)].  A walker past W is
// dead: its lanes read the last walker's operands and write nothing.
struct LaneFrame {
  int tid, nt;       // the thread in the block, the block's threads
  int lane, lanes;   // the lane within the walker, the walker's lanes
  int wl, wpb;       // the walker within the block, walkers a block
  int w0, w, wc, W;  // the block's first walker, the walker, the one it reads, all
  int pitch;         // bytes of one rank's row of the block's codes
  unsigned mask;     // the walker's lanes within the warp
  bool live;

  __device__ LaneFrame(int lanes_, int walkers_per_block, int W_)
      : tid(threadIdx.x), nt(blockDim.x), lanes(lanes_), wpb(walkers_per_block), W(W_),
        pitch(code_pitch(walkers_per_block)) {
    const int shift = __ffs(lanes) - 1;  // lanes is a power of two
    wl = tid >> shift;
    lane = tid & (lanes - 1);
    const unsigned group = lanes == 1 ? 1u : (1u << lanes) - 1u;
    mask = group << ((tid & 31) & ~(lanes - 1));
    w0 = blockIdx.x * wpb;
    w = w0 + wl;
    live = w < W;
    wc = live ? w : W - 1;
  }

  // The block's codes into shared memory (a dead walker's column holds
  // the last walker's), and back.
  __device__ void load_codes(int8_t* s_occ, const int8_t* __restrict__ occ, int R) const {
    for (int x = tid; x < R * wpb; x += nt) {
      const int r = x / wpb;
      const int c = x % wpb;
      s_occ[r * pitch + c] = occ[(size_t)r * W + min(w0 + c, W - 1)];
    }
  }
  __device__ void store_codes(int8_t* __restrict__ occ, const int8_t* s_occ, int R) const {
    for (int x = tid; x < R * wpb; x += nt) {
      const int r = x / wpb;
      const int c = x % wpb;
      if (w0 + c < W) occ[(size_t)r * W + w0 + c] = s_occ[r * pitch + c];
    }
  }
};

// log U of step i, drawn G steps at a time: at every G-th step lane j
// draws step i + j into `mine` (r_u, the step's only uniform), and step i
// reads it from lane i % G.
__device__ __forceinline__ float lane_log_u(float& mine, const Draws& draws, int i,
                                            int n_steps, int rng_mode, const LaneFrame& f) {
  const int slot = i & (f.lanes - 1);
  if (slot == 0 && i + f.lane < n_steps) mine = log_uniform(draws.at(i + f.lane, rng_mode).x);
  return __shfl_sync(f.mask, mine, slot, f.lanes);
}

// Whether a lane kernel takes a launch's shape: G a power of two up to
// 16, at most `max_threads` threads a block, a block inside one sequence
// group of `block_size` walkers (its threads share the group's
// proposals), `resident` 0 or 1.
inline bool lane_launch_ok(int W, int lanes, int walkers_per_block, int block_size,
                           int max_threads, int resident) {
  const bool lanes_ok = lanes >= 1 && lanes <= 16 && (lanes & (lanes - 1)) == 0;
  return W >= 1 && lanes_ok && walkers_per_block >= 1 &&
         walkers_per_block * lanes <= max_threads &&
         (W <= block_size || block_size % walkers_per_block == 0) && (resident == 0 || resident == 1);
}

// One lane's rows of a rank, for each body: rows lane, lane + lanes, ...
// in row order.  The direct and q-ary bodies add their terms to `acc`
// (kScaled false); the Ising body returns its rows' parity sum, which the
// caller scales by -2 (b - a) after the lanes meet (kScaled true).
template <class Body>
struct Lanes;

template <int KT>
struct Lanes<Direct<KT>> {
  static constexpr bool kScaled = false;
  // BATCH > 1 (a compile-time slot count only): the lane's rows in batches
  // of BATCH whose loads are all issued before any term is added; the
  // terms are added in row order, as at BATCH = 1.  A row past the count
  // reads the last row again and is not added.
  template <int BATCH = 1>
  static __device__ __forceinline__ double add(double acc, const Rows& rows,
                                               const Tables& t, int, const int8_t* codes,
                                               int pitch, int a, int b, const NoWalker&,
                                               int lane, int lanes) {
    const int K = KT > 0 ? KT : t.K;
    if constexpr (BATCH > 1 && KT > 0) {
      const int L = t.L;
      for (int l0 = lane; l0 < L; l0 += BATCH * lanes) {
        int x[BATCH], d[BATCH], lr[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          lr[j] = min(l0 + j * lanes, L - 1);
          d[j] = rows.d2[lr[j]];
          x[j] = d[j] * a;
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            const int n = rows.nbr[lr[j] * KT + k];
            const int code = n >= 0 ? (int)codes[n * pitch] : 0;
            x[j] += rows.st[lr[j] * KT + k] * code;
          }
        }
        double term[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const double* g = rows.g + lr[j] * t.TM;
          term[j] = g[x[j] + d[j] * (b - a)] - g[x[j]];
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          if (l0 + j * lanes < L) acc += term[j];
        }
      }
      return acc;
    }
#pragma unroll 1
    for (int l = lane; l < t.L; l += lanes) {
      const int d = rows.d2[l];
      int x = d * a;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int n = rows.nbr[l * K + k];
        const int code = n >= 0 ? (int)codes[n * pitch] : 0;
        x += rows.st[l * K + k] * code;
      }
      const int xn = x + d * (b - a);
      const double term = rows.g[l * t.TM + xn] - rows.g[l * t.TM + x];
      acc += term;
    }
    return acc;
  }
};

template <int Q, int NBT>
struct Lanes<Qary<Q, NBT>> {
  static constexpr bool kScaled = false;
  // BATCH > 1 (a compile-time neighbour count only): as Lanes<Direct>.
  template <int BATCH = 1>
  static __device__ __forceinline__ double add(double acc, const QRows& r,
                                               const Tables& t, int u, const int8_t* codes,
                                               int pitch, int a, int b, const NoWalker&,
                                               int lane, int lanes) {
    const int NB = NBT > 0 ? NBT : t.NB;
    const int n = __ldg(t.qrows + u);
    if constexpr (BATCH > 1 && NBT > 0) {
      for (int l0 = lane; l0 < n; l0 += BATCH * lanes) {
        int wo[BATCH], wn[BATCH], lr[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          lr[j] = min(l0 + j * lanes, n - 1);
          int ph = 0;
#pragma unroll
          for (int k = 0; k < NBT; ++k) {
            const int nb = r.nbr[lr[j] * NBT + k];
            const int code = nb >= 0 ? (int)codes[nb * pitch] : 0;
            ph += r.freq[lr[j] * NBT + k] * code;
          }
          const int m = r.ms[lr[j]];
          wo[j] = (ph + m * a) % Q;
          wn[j] = (ph + m * b) % Q;
        }
        double term[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          term[j] = r.ac[lr[j]] * (double)(sigma_c<Q>(wn[j]) - sigma_c<Q>(wo[j]));
          if constexpr (Q != 2) {
            term[j] += r.as[lr[j]] * (double)(sigma_s<Q>(wn[j]) - sigma_s<Q>(wo[j]));
          }
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          if (l0 + j * lanes < n) acc += term[j];
        }
      }
      return acc;
    }
#pragma unroll 1
    for (int l = lane; l < n; l += lanes) {
      int ph = 0;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int nb = r.nbr[l * NB + k];
        const int code = nb >= 0 ? (int)codes[nb * pitch] : 0;
        ph += r.freq[l * NB + k] * code;
      }
      const int m = r.ms[l];
      const int wo = (ph + m * a) % Q;
      const int wn = (ph + m * b) % Q;
      double term = r.ac[l] * (double)(sigma_c<Q>(wn) - sigma_c<Q>(wo));
      if constexpr (Q != 2) {
        term += r.as[l] * (double)(sigma_s<Q>(wn) - sigma_s<Q>(wo));
      }
      acc += term;
    }
    return acc;
  }
};

template <int NW>
struct Lanes<Ising<NW>> {
  static constexpr bool kScaled = true;
  // The lane's parity sum from +0.0.  Every term is +-A_l exactly and the
  // scale 0 or +-2, so the f64 adds of S are the only roundings, and the
  // one dependent chain: the rows are taken in batches of kLaneBatch whose
  // masks and amplitudes are all loaded before any is used, an empty asm
  // with a memory clobber between the loads and the sums (without it
  // ptxas moved each row's shared-memory loads next to their use, a round
  // trip per row).  A row past the rank's count loads as mask 0 and
  // amplitude +0.0 and adds +0.0, which leaves the sum (never -0.0)
  // unchanged.  The twin (ops/chain.py _ising_sum) sums in this order.
  static __device__ __forceinline__ double sum(const IRows& r, const Tables& t, int u,
                                               const Bits<NW>& bits, int lane, int lanes) {
    const int n = __ldg(t.irows + u);
    double s = 0.0;
    for (int l0 = lane; l0 < n; l0 += kLaneBatch * lanes) {
      uint64_t mask[kLaneBatch][NW];
      double A[kLaneBatch];
#pragma unroll
      for (int j = 0; j < kLaneBatch; ++j) {
        const int l = l0 + j * lanes;
        const bool ok = l < n;
#pragma unroll
        for (int k = 0; k < NW; ++k) mask[j][k] = ok ? r.mask[l * NW + k] : 0ull;
        A[j] = ok ? r.amp[l] : 0.0;
      }
      asm volatile("" ::: "memory");  // every load of the batch issued first
#pragma unroll
      for (int j = 0; j < kLaneBatch; ++j) s += ising_term<NW>(mask[j], A[j], bits);
    }
    return s;
  }
};

// A flip's delta over the lanes: the body's rows, then the Ewald term (in
// rank order, on every lane), then minus the chemical work (mu is [R, C]).
// At one lane, the rows' terms in row order from +0.0.  BATCH: the direct
// and q-ary rows a lane loads before it adds them (Lanes<Body>::add).
template <class Body, bool EW, int BATCH = 1>
__device__ __forceinline__ double lane_flip_delta(
    const typename Body::Rows& ru, const Tables& t, int u, int a, int b,
    const int8_t* codes, int pitch, int R, int C, const double* __restrict__ mu,
    const double* __restrict__ ew_c, const typename Body::Walker& wk, int lane,
    int lanes, unsigned mask) {
  using L = Lanes<Body>;
  double dE;
  if constexpr (L::kScaled) {
    const double s = lane_sum(L::sum(ru, t, u, wk, lane, lanes), mask, lanes);
    dE = 0.0 + (double)(-2 * (b - a)) * s;
  } else {
    dE = lane_sum(L::template add<BATCH>(0.0, ru, t, u, codes, pitch, a, b, wk, lane, lanes),
                  mask, lanes);
  }
  if constexpr (EW) {
    dE += ewald_term(ru.ew, __ldg(ew_c + u), codes, pitch, 0, R, b - a);
  }
  const double work = __ldg(mu + u * C + b) - __ldg(mu + u * C + a);
  dE -= work;
  return dE;
}

// K4 split over the lanes: lane j takes ranks j, j + G, ... of the dot in
// rank order from +0.0, the partials meet in the butterfly, then sign *
// (C_r + dot).  At one lane, ewald_term's sum.
__device__ __forceinline__ double lane_ewald_term(const double* row, double c,
                                                  const int8_t* codes, int pitch,
                                                  int R, int sign, int lane,
                                                  int lanes, unsigned mask) {
  double acc = 0.0;
#pragma unroll 4
  for (int t = lane; t < R; t += lanes) acc += row[t] * (double)codes[t * pitch];
  return (double)sign * (c + lane_sum(acc, mask, lanes));
}

// K4 of a rank going a -> b (sign b - a): split over the lanes (SPLIT),
// else in rank order on every lane.
template <bool SPLIT>
__device__ __forceinline__ double ewald_of(const double* row, double c,
                                           const int8_t* codes, int pitch, int R,
                                           int sign, int lane, int lanes,
                                           unsigned mask) {
  if constexpr (SPLIT) return lane_ewald_term(row, c, codes, pitch, R, sign, lane, lanes, mask);
  return ewald_term(row, c, codes, pitch, 0, R, sign);
}

// A swap's joint delta over the lanes: rank u (rows ru, cell cu) going
// a -> b, then (lane 0 writing b into u's cell between two warp barriers)
// rank v (rows rv) going b -> a against the occupancy with u already
// holding b, then u's Ewald term (taken before u is recolored), then v's.
// The direct and q-ary bodies sum u's rows then v's into one partial a
// lane, which meet after v's; K1-Ising's parity sums of u and of v meet
// apart, each scaled by its rank's -2 (b - a).  Leaves b in u's cell: on
// accept the caller writes a into v's cell, on reject a back into u's (and
// on accept updates the walker's register state `wk`).  With the q-ary
// body v's phases read u's new code, which stands for the reference's
// rank-1 correction `corr` (:596-603); with the Ising body v's parities
// read a copy of the walker's bits with u's bit set to b, which stands for
// the reference's membership correction (:424-432).  At one lane, the rows
// in row order from +0.0.  BATCH: the direct and q-ary rows a lane loads
// before it adds them (Lanes<Body>::add); SPLIT: K4 over the lanes (the
// swap chain), else in rank order on every lane (the Wang-Landau chain).
template <class Body, bool EW, int BATCH = 1, bool SPLIT = false>
__device__ __forceinline__ double lane_swap_delta(
    const typename Body::Rows& ru, const typename Body::Rows& rv, const Tables& t, int u,
    int v, int8_t* cu, int a, int b, const int8_t* codes, int pitch, int R,
    const double* __restrict__ ew_c, const typename Body::Walker& wk, int lane, int lanes,
    unsigned mask) {
  using L = Lanes<Body>;
  double ewald_u = 0.0;  // taken before u is recolored
  if constexpr (EW && !L::kScaled) {
    ewald_u = ewald_of<SPLIT>(ru.ew, __ldg(ew_c + u), codes, pitch, R, b - a, lane, lanes,
                              mask);
  }
  typename Body::Walker wv = wk;
  wv.set(u, b);
  double dE;
  if constexpr (L::kScaled) {
    const double su = L::sum(ru, t, u, wk, lane, lanes);
    const double sv = L::sum(rv, t, v, wv, lane, lanes);
    // the parity sums read no codes: the dot after them ran K2's K1-Ising
    // windows with the Ewald term 4-8 % faster on an H100 (PERF.md)
    if constexpr (EW) {
      ewald_u = ewald_of<SPLIT>(ru.ew, __ldg(ew_c + u), codes, pitch, R, b - a, lane, lanes,
                                mask);
    }
    __syncwarp(mask);  // every lane has read a before it changes
    if (lane == 0) *cu = (int8_t)b;  // v's Ewald term sees u holding b
    __syncwarp(mask);
    dE = 0.0 + (double)(-2 * (b - a)) * lane_sum(su, mask, lanes);
    dE = dE + (double)(-2 * (a - b)) * lane_sum(sv, mask, lanes);
  } else {
    double acc = L::template add<BATCH>(0.0, ru, t, u, codes, pitch, a, b, wk, lane, lanes);
    __syncwarp(mask);  // every lane has read u's rows' codes before they change
    if (lane == 0) *cu = (int8_t)b;  // v's rows see u already holding b
    __syncwarp(mask);
    acc = L::template add<BATCH>(acc, rv, t, v, codes, pitch, b, a, wv, lane, lanes);
    dE = lane_sum(acc, mask, lanes);
  }
  if constexpr (EW) {
    dE += ewald_u;
    dE += ewald_of<SPLIT>(rv.ew, __ldg(ew_c + v), codes, pitch, R, a - b, lane, lanes, mask);
  }
  return dE;
}

// Raise the dynamic shared-memory limit where the kernel needs above 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace smol

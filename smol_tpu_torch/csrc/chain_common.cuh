// Pieces shared by the chain kernels flip_chain.cu, swap_chain.cu,
// table_chain.cu, wl_chain.cu and distance_chain.cu.
//
// - the random bits: the reference's interpret-mode hash, bit for bit, and
//   Philox4x32-10 (replacing the TPU hardware PRNG of smol_tpu/ops/prims.py);
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
//   `ewald_delta` (:1651), in f64 over the block's codes in rank order;
// - the whole delta of a flip and of a swap (flip_delta, swap_delta, with
//   the body as a template parameter), which the Metropolis chains and the
//   Wang-Landau chain call.
//
// The plain torch twins in ops/chain.py sum in the same orders, so kernel
// and twin give the same f64 deltas.  Build without fast-math: nothing may
// reorder these sums.

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace smol {

constexpr int kMaxThreads = 64;
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

// Accept on an f32 exponent: expo >= 0 or expo > log U, with U in (0, 1]
// from the 31 random bits r_u, as the reference takes it (:1879, :1883).
__device__ __forceinline__ bool accept_exponent(float expo, uint32_t r_u) {
  const float unif = ((float)(r_u >> 7) + 1.0f) * 5.9604644775390625e-8f;
  return expo >= 0.0f || expo > logf(unif);
}

// The Metropolis decision in f32, as the reference takes it (:1882).
__device__ __forceinline__ bool metropolis(float beta, double dE, uint32_t r_u) {
  return accept_exponent(-beta * (float)dE, r_u);
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

// dE plus the cluster-expansion change of the rank whose rows are `rows`
// going from code a to b, one term per local cluster in order l = 0, 1, ...:
// t = d2 * a + sum_k stride * code(nbr), term = g[l, t + d2 (b - a)] - g[l, t].
// KT > 0: the slot count K as a compile-time constant; KT == 0: runtime K.
// On an H100 a runtime K ran 2.8x slower per step than the constant on the
// spinel (K = 3), so K = 3 has its own instantiations.
template <int KT>
__device__ __forceinline__ double ce_add(double dE, const Rows& rows,
                                         const int8_t* s_occ, int nt, int tid,
                                         int L, int K_rt, int TM, int a,
                                         int b) {
  const int K = KT > 0 ? KT : K_rt;
#pragma unroll 8
  for (int l = 0; l < L; ++l) {
    const int d = rows.d2[l];
    int t = d * a;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int n = rows.nbr[l * K + k];
      const int code = n >= 0 ? (int)s_occ[n * nt + tid] : 0;
      t += rows.st[l * K + k] * code;
    }
    const int tn = t + d * (b - a);
    const double term = rows.g[l * TM + tn] - rows.g[l * TM + t];
    dE += term;
  }
  return dE;
}

// K3's character rows of one rank in shared memory (ops/chain.py
// qary_tables): row l is the character sum_k freq[l, k] code(nbr[l, k]) +
// ms[l] code(self) (mod Q) with folded amplitudes ac[l], as[l].
// The q-ary body takes no Ewald term (the tables refuse one).
struct QRows {
  double* ac;     // [Lq]
  double* as;     // [Lq]
  int32_t* nbr;   // [Lq, NB] neighbour rank, -1 = none
  int32_t* freq;  // [Lq, NB] scaled frequency in [0, Q)
  int32_t* ms;    // [Lq] scaled self frequency in [1, Q)
};

__host__ __device__ __forceinline__ size_t qrows_bytes(int Lq, int NB) {
  const size_t bytes = (size_t)Lq * 16 + (size_t)Lq * (2 * NB + 1) * 4;
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ QRows qrows_at(unsigned char* base, int Lq, int NB) {
  QRows r;
  r.ac = reinterpret_cast<double*>(base);
  r.as = r.ac + Lq;
  r.nbr = reinterpret_cast<int32_t*>(r.as + Lq);
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

// The direct body: one rank's local-cluster rows (Rows), ce_add.
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
  __device__ static double add(double dE, const Rows& r, const Tables& t, int u,
                               const int8_t* s_occ, int nt, int tid, int a,
                               int b, const Walker&) {
    return ce_add<KT>(dE, r, s_occ, nt, tid, t.L, t.K, t.TM, a, b);
  }
};

// K3's folded phase selectors, pallas_chain.py `_phase_sel` (:476): cos and
// sin of 2 pi w / Q over their folds (ops/chain.py QARY_SIGMA).
template <int Q>
__device__ __forceinline__ int sigma_c(int w) {
  if constexpr (Q == 2) return 1 - 2 * w;
  return w == 0 ? 1 : 0;
}

template <int Q>
__device__ __forceinline__ int sigma_s(int w) {
  if constexpr (Q == 2) return 0;
  return (w == 1 ? 1 : 0) - (w == 2 ? 1 : 0);
}

// K3: dE plus the change of the rank's n character rows (rows `r`) when
// its code goes a -> b, in row order l = 0 .. n-1.  The neighbour phase
// u = sum_k freq * code(nbr) is an integer >= 0, the phases (u + ms a) mod Q
// and (u + ms b) mod Q, and the row's change ac dc + as ds with dc, ds in
// {0, +-1, +-2}: both products are exact, so whether nvcc contracts the sum
// into an FMA or not, it rounds once, as the twin's does (Q = 2 has no sin
// characters).  NBT > 0: the neighbours per row as a compile-time constant.
template <int Q, int NBT>
__device__ __forceinline__ double qary_add(double dE, const QRows& r, int n,
                                           const int8_t* s_occ, int nt,
                                           int tid, int NB_rt, int a, int b) {
  const int NB = NBT > 0 ? NBT : NB_rt;
#pragma unroll 4
  for (int l = 0; l < n; ++l) {
    int ph = 0;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int nb = r.nbr[l * NB + k];
      const int code = nb >= 0 ? (int)s_occ[nb * nt + tid] : 0;
      ph += r.freq[l * NB + k] * code;
    }
    const int m = r.ms[l];
    const int wo = (ph + m * a) % Q;
    const int wn = (ph + m * b) % Q;
    double term = r.ac[l] * (double)(sigma_c<Q>(wn) - sigma_c<Q>(wo));
    if constexpr (Q != 2) {
      term += r.as[l] * (double)(sigma_s<Q>(wn) - sigma_s<Q>(wo));
    }
    dE += term;
  }
  return dE;
}

// The q-ary body: a rank's qrows[u] character rows (QRows), qary_add.
template <int Q, int NBT>
struct Qary {
  using Rows = QRows;
  using Walker = NoWalker;
  // the neighbour count as a compile-time constant where the body has one
  __device__ static void pin(Tables& t) {
    if constexpr (NBT > 0) t.NB = NBT;
  }
  __host__ __device__ static size_t bytes(const Tables& t) {
    return qrows_bytes(t.Lq, t.NB);
  }
  __device__ static Rows at(unsigned char* base, const Tables& t) {
    return qrows_at(base, t.Lq, t.NB);
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
    __pipeline_commit();
  }
  __device__ static double add(double dE, const Rows& r, const Tables& t, int u,
                               const int8_t* s_occ, int nt, int tid, int a,
                               int b, const Walker&) {
    return qary_add<Q, NBT>(dE, r, __ldg(t.qrows + u), s_occ, nt, tid, t.NB, a,
                            b);
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

// K1-Ising: dE plus -2 (b - a) S for the rank's n rows, S = sum over rows l
// of A_l (-1)^{t_l}, summed in row order l = 0 .. n-1 from 0.0.  Every term
// is +-A_l exactly and the scale is 0 or +-2, so the f64 adds of S are the
// only roundings, and the one dependent chain: the rows are taken in
// batches of kIsingBatch whose masks and amplitudes are all loaded before
// any is used, an empty asm with a memory clobber between the loads and
// the sums (without it ptxas moved each row's shared-memory loads next to
// their use, a round trip per row, in one loop as in batches).  The twin
// (ops/chain.py _ising_terms) sums in this order.
constexpr int kIsingBatch = 16;

template <int NW>
__device__ __forceinline__ double ising_add(double dE, const IRows& r, int n,
                                            const Bits<NW>& bits, int a, int b) {
  double s = 0.0;
  int l = 0;
  for (; l + kIsingBatch <= n; l += kIsingBatch) {
    uint64_t mask[kIsingBatch][NW];
    double A[kIsingBatch];
#pragma unroll
    for (int j = 0; j < kIsingBatch; ++j) {
#pragma unroll
      for (int k = 0; k < NW; ++k) mask[j][k] = r.mask[(l + j) * NW + k];
      A[j] = r.amp[l + j];
    }
    asm volatile("" ::: "memory");  // every load of the batch issued first
#pragma unroll
    for (int j = 0; j < kIsingBatch; ++j) s += ising_term<NW>(mask[j], A[j], bits);
  }
  for (; l < n; ++l) {
    uint64_t mask[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) mask[k] = r.mask[l * NW + k];
    s += ising_term<NW>(mask, r.amp[l], bits);
  }
  return dE + (double)(-2 * (b - a)) * s;
}

// The Ising body: a rank's irows[u] parity rows (IRows) and the walker's
// codes as bits (Bits<NW>), ising_add.  NW, the words of rank bits (1 to 4:
// up to 256 ranks), is a compile-time constant.
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
  // inlined, so that the walker's bits stay in registers (a call taking
  // them by reference would put them on the stack)
  static __device__ __forceinline__ double add(double dE, const Rows& r,
                                               const Tables& t, int u,
                                               const int8_t*, int, int, int a,
                                               int b, const Walker& bits) {
    return ising_add<NW>(dE, r, __ldg(t.irows + u), bits, a, b);
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

// A flip's delta: rank u (rows `rows` of the body `Body`, the walker's
// register state `wk`) going from code a to b.  Cluster terms, then the
// Ewald term, then minus the chemical work mu[u, b] - mu[u, a] (mu is
// [R, C]).
template <class Body, bool EW>
__device__ __forceinline__ double flip_delta(
    const typename Body::Rows& rows, const Tables& t, int u, int a, int b,
    const int8_t* s_occ, int nt, int tid, int R, int C,
    const double* __restrict__ mu, const double* __restrict__ ew_c,
    const typename Body::Walker& wk = typename Body::Walker()) {
  double dE = Body::add(0.0, rows, t, u, s_occ, nt, tid, a, b, wk);
  if constexpr (EW) {
    dE += ewald_term(rows.ew, __ldg(ew_c + u), s_occ, nt, tid, R, b - a);
  }
  const double work = __ldg(mu + u * C + b) - __ldg(mu + u * C + a);
  dE -= work;
  return dE;
}

// A swap's joint delta: rank u (rows ru, cell cu) going a -> b, then rank v
// (rows rv) going b -> a against the occupancy with u already holding b,
// then u's Ewald term (taken before u is recolored), then v's.  Leaves b in
// u's cell: on accept the caller writes a into v's cell, on reject a back
// into u's (and on accept updates the walker's register state `wk`).  With
// the q-ary body v's phases read u's new code, which stands for the
// reference's rank-1 correction `corr` (:596-603); with the Ising body v's
// parities read a copy of the walker's bits with u's bit set to b, which
// stands for the reference's membership correction (:424-432).
template <class Body, bool EW>
__device__ __forceinline__ double swap_delta(
    const typename Body::Rows& ru, const typename Body::Rows& rv,
    const Tables& t, int u, int v, int8_t* cu, int a, int b,
    const int8_t* s_occ, int nt, int tid, int R,
    const double* __restrict__ ew_c,
    const typename Body::Walker& wk = typename Body::Walker()) {
  double ewald_u = 0.0;
  if constexpr (EW) {
    ewald_u = ewald_term(ru.ew, __ldg(ew_c + u), s_occ, nt, tid, R, b - a);
  }
  double dE = Body::add(0.0, ru, t, u, s_occ, nt, tid, a, b, wk);
  *cu = (int8_t)b;  // v's delta sees u already holding b
  typename Body::Walker wv = wk;
  wv.set(u, b);
  dE = Body::add(dE, rv, t, v, s_occ, nt, tid, b, a, wv);
  if constexpr (EW) {
    dE += ewald_u;
    dE += ewald_term(rv.ew, __ldg(ew_c + v), s_occ, nt, tid, R, a - b);
  }
  return dE;
}

inline int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Threads of a CUDA block: a block must lie inside one sequence group of
// block_size walkers, since its threads share the group's proposals.
inline int block_threads(int W, int block_size) {
  return (W <= block_size || block_size % kMaxThreads == 0)
             ? kMaxThreads
             : gcd(block_size, kMaxThreads);
}

// Raise the dynamic shared-memory limit where the kernel needs above 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace smol

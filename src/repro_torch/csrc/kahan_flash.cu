// Flash attention with compensated online-softmax accumulators on Hopper.
//
// Replaces the two Pallas calls of the JAX package that share the block
// body flash_block_update (repro/kernels/flash_attention.py:76-137):
//   flash_accumulators        (:262, body _flash_kernel)        q_off = 0
//   flash_chunk_accumulators  (:377, body _flash_chunk_kernel)  q_off = the
//                              chunk's absolute offset, always causal
// One C entry point serves both.
//
// What it computes: for every head-row bh and query row i, the k axis is
// walked in blocks of exactly block_k keys, in order (the k-block size is
// part of the numbers: the row maximum, rowsum_tree's shape and pairwise's
// step-indexed fold all depend on it), and each k-block is folded by the
// reference's op sequence:
//   s = q . k over dh, ascending d          p = exp(s - m_new)
//   s = s * scale                           p_sum = rowsum_tree(p)
//   mask: key < kv_len, causal q_off+i >= key    pv = p . v over the block,
//         (masked entries become -1e30)               ascending key
//   m_new = max(m_old, rowmax(s))           l, acc pairs scaled by corr
//   corr = exp(m_old - m_new)               update(l, p_sum, kb),
//                                           update(acc, pv, kb)
// with the scheme's update from schemes.cuh, step index kb. The kernel
// emits the raw (l_s, l_c, acc_s, acc_c) grids; finalize and the division
// stay in torch (kernels/engine.py), as they stay outside Pallas in the
// reference. Fully masked blocks still run (no pruning: it would change
// the raw pairs of kahan and pairwise). No atomics. GQA: k/v head-row
// bh / q_groups serves the q_groups consecutive query head-rows.
//
// Arithmetic: built with -fmad=false like kahan_reduce.cu, so no product
// is contracted (the reference pins every op behind optimization_barrier)
// and every contraction is a single ascending chain of rounded products
// and rounded adds, which the plain version in kernels/flash_attention.py
// repeats op for op. expf is the accurate one (no __expf, no fast-math),
// as torch.exp on the card. A row's bits depend on nothing but its own
// chains, so they do not depend on the tile height: a B8 chunk and a B7
// grid give the same rows.
//
// Compute dtypes: the kernel is a template on T, the dtype of q, k, v, of
// the K/V ring and of the four outputs (the reference's compute dtype, to
// which the engine promotes q, k and v), and C = Compute<T> is the type
// every value is formed in (the scores, m, l, acc and both compensations):
// - float: C = float, the tiles and vector paths below;
// - double: C = double; exp() (libdevice, what torch.exp calls on a CUDA
//   float64 tensor), NEG_INF the double -1e30, the scale dh^-0.5 as the
//   host's double (the reference's weakly typed Python float);
// - Bf16 (schemes.cuh): C = Bf16f, a bfloat16 value held in a float, each
//   op computed in float and rounded to bfloat16 once by one cvt, as
//   torch computes a bfloat16 op: the scale rounded to bfloat16, exp as
//   expf of the value, then rounded (an exp argument is a bfloat16 value,
//   so none lies within 2^-9 of -87.34, the only place where -ftz=true's
//   zero for an expf result below 2^-126 could part from torch's rounding
//   of that float32 subnormal). The q tile, the score block and the row
//   statistics hold floats (q widened once, exactly, as it enters); the
//   K/V ring holds the bfloat16 elements as cp.async copies them, each
//   widened as it is read (four elements an 8-byte read): that timed
//   faster than widening each sub-tile once in its slot, whose raw copies
//   needed a second barrier a sub-tile (PERF.md).
// The k-block, and so the bits, is the caller's whatever T is.
//
// What bounds it on the H100: the fixed chains. Each term is a rounded
// product and a rounded add in a set order, so neither fma nor the tensor
// cores may form it, and the ceiling is half the fp32 fma rate: 4 * BH *
// Sq_pad * Skv_pad * dh FLOPs (both contractions, masked blocks included)
// at 33.5 TFLOP/s, 1.026 ms for OLMo-1B's 2048-token prefill ([16, 2048,
// 128]); half that rate in double. A bfloat16 term adds two roundings,
// one cvt each, to its float multiply and add. q, k, v and the four
// outputs cross HBM once each, far less time at 3.35 TB/s. So the design
// feeds the multiply and add units and hides every load behind them.
//
// Layout: one CTA of 256 threads = TQ query rows of one head-row (grid:
// ceil(Sq / TQ) x BH), chosen on the host by
// kernels/flash_attention.py::flash_plan among the heights of its type,
// float and Bf16 64 or 16, double 32 or 16: the tall tile where the grid
// still has two CTAs per SM (B7: 512 CTAs at 64 rows, 1024 at 32), else
// 16 (a 64-row B8 chunk: 64 CTAs), and the tall one only where a
// thread's acc rows cover it (dh <= 128). Per k-block, K then V stream
// through a ring of 2 stages of KEYS-key sub-tiles, KEYS 64 but 32 for
// double's 32-row tile, whose 64-key stages would not fit beside its
// score block (row stride ld = dh + 16 bytes, or dh + 1 when those rows
// are not 16-byte aligned). Shared memory, all regions 16-byte aligned,
// vec the elements of a region's type in 16 bytes:
//   TQ * ld                         the q tile (C), rows padded like K's
//   TQ * (round_vec(block_k) + vec) the score / probability block (C)
//   2 * round_vec(min(KEYS, block_k) * ld)    the K/V ring (T)
//   4 * TQ                          m, corr, l_s, l_c per row (C)
// At dh 128, block_k 256: float TQ 64 168960 bytes (one CTA an SM), TQ
// 16 92928, Bf16 136192 and 60160; at dh 256, block_k 1024 only TQ 16
// fits (215808 of 232448). double at dh 128, block_k 256: TQ 32 166912
// bytes, TQ 16
// 183296; block_k 512 fits both (TQ 32 at 232448 exactly), 1024 neither
// (the host's plan refuses it). The C entry recomputes the bytes and
// refuses a plan that disagrees or does not fit.
//
// Why these tiles (scripts/flash_tiles.py times every height; PERF.md has
// the numbers): 64 rows of 8 warps, one CTA an SM, beat 16-row tiles at
// B7 even when those ran two CTAs (16 warps) an SM under a 128-register
// cap, since a 16-row CTA reads K and V four times as often and its 1 x 4
// score tiles wait on shared memory; every tile is built for one CTA an
// SM (up to 255 registers, no spill). The ring is 2 stages deep: a third
// timed the same at B7, and 2 fit every dh and block_k.
//
// The four causes of the earlier 16-row kernel's speed (7.3 ms at B7,
// 14% of the ceiling), and what answers each:
// 1. K and V were read by 16-row CTAs, 2048 of them at B7: TQ 64 (32 in
//    double) cuts the K/V traffic through L2 four (two) times.
// 2. Staging was synchronous (scalar loads, then a barrier): the ring
//    streams K0..Kn, V0..Vn of each k-block, and the next k-block's, with
//    16-byte cp.async.cg copies issued one sub-tile ahead, one
//    barrier a sub-tile; the V sub-tiles are in flight during the softmax
//    and the q tile rides in the first group (Bf16 widens its q tile
//    with plain 16-byte loads). Rows that are not 16-byte aligned (the C
//    entry checks the q, k and v pointers; dh % vec != 0) take plain
//    loads into the same ring.
// 3. Little register reuse: each thread forms a register tile. Scores:
//    TQ / 16 rows x KEYS / 16 keys (4 x 4 at TQ 64, 2 x 2 in double's
//    TQ 32, 1 x 4 at TQ 16), q and k read four elements at a time along
//    dh (a float4, two double2), the loop unrolled so the next loads issue
//    early; keys tx + 16 c and the ld = dh + 16 bytes stride put the 8
//    keys of a quarter-warp on 8 different 16-byte bank groups when dh %
//    (2 vec) == 0, and the q rows a warp reads are two, each broadcast.
//    PV: rows rg + RG r x 4 columns (8 rows at TQ 64, dh 128; the row
//    count a compile-time constant, so no guard splits the loop), p read
//    along the keys (one row a warp, broadcast) and v along dh (a warp's
//    32 quads contiguous: 4 adjacent columns a thread in float, in double
//    the pairs 2 quad and 2 (quad + nq), so that each double2 read of a
//    warp is contiguous), run key by key over every cell so that no add
//    waits on the one before; pv runs across the whole k-block, the
//    sub-tiles in order and j in order within each.
// 4. The rowsum tree lived in shared memory with a __syncwarp a level:
//    one warp a row holds p[j] for j = lane + 32 m in registers; levels
//    with h >= 32 add a lane's own registers, levels below use
//    __shfl_down_sync, each pairing t[j] + t[j + h] as rowsum_tree does.
//    The number of registers a lane holds is a constant for each power of
//    two of block_k, and a warp takes two rows at once up to 256 keys, so
//    no branch serialises the loads and exps of a row.
// dh % 4 != 0 and a block_k tail that is not a multiple of the key step
// take scalar forms of the same loops. The scheme is a runtime switch at
// the two folds (once per cell and k-block). Instantiations: float and
// Bf16 at TQ 64 and 16, double at TQ 32 and at TQ 16 with two acc rows a
// thread (dh <= 128) and with four (dh > 128).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "schemes.cuh"

namespace {

using namespace repro_schemes;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;                // K/V ring depth
constexpr int kMaxDh = 256;
constexpr int kMaxBk = 1024;
constexpr int kSmemLimit = 232448;

// What differs between the compute types: NEG_INF of the reference in
// the type, exp as torch computes it on a CUDA tensor of the dtype, the
// row maximum and the warp shuffles.
template <typename C> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float neg_inf() { return -1e30f; }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float max(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float shfl_xor(float x, int o) {
    return __shfl_xor_sync(0xffffffffu, x, o);
  }
  static __device__ __forceinline__ float shfl_down(float x, int o) {
    return __shfl_down_sync(0xffffffffu, x, o);
  }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double neg_inf() { return -1e30; }
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double max(double a, double b) {
    return fmax(a, b);
  }
  static __device__ __forceinline__ double shfl_xor(double x, int o) {
    return __shfl_xor_sync(0xffffffffu, x, o);
  }
  static __device__ __forceinline__ double shfl_down(double x, int o) {
    return __shfl_down_sync(0xffffffffu, x, o);
  }
};
template <> struct Num<Bf16f> {
  // -1e30 rounded to bfloat16
  static __device__ __forceinline__ Bf16f neg_inf() {
    return Bf16f::exact(__uint_as_float(0xf14a0000u));
  }
  static __device__ __forceinline__ Bf16f exp(Bf16f x) {
    return Bf16f(expf(x.x));
  }
  static __device__ __forceinline__ Bf16f max(Bf16f a, Bf16f b) {
    return a.x < b.x ? b : a;
  }
  static __device__ __forceinline__ Bf16f shfl_xor(Bf16f x, int o) {
    return Bf16f::exact(__shfl_xor_sync(0xffffffffu, x.x, o));
  }
  static __device__ __forceinline__ Bf16f shfl_down(Bf16f x, int o) {
    return Bf16f::exact(__shfl_down_sync(0xffffffffu, x.x, o));
  }
};

// the two bfloat16 of a 32-bit word, widened
__device__ __forceinline__ Bf16f lo_of(unsigned w) {
  return Bf16f::exact(__uint_as_float(w << 16));
}
__device__ __forceinline__ Bf16f hi_of(unsigned w) {
  return Bf16f::exact(__uint_as_float(w & 0xffff0000u));
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// elements of E in 16 bytes: one cp.async chunk, and the padding unit
template <typename E> __host__ __device__ constexpr int vec_of() {
  return 16 / (int)sizeof(E);
}

template <typename E> __host__ __device__ inline int round_vec(int n) {
  return (n + vec_of<E>() - 1) / vec_of<E>() * vec_of<E>();
}

// row stride of the q tile and the K/V sub-tiles: dh + 16 bytes keeps rows
// 16-byte aligned for vector reads and cp.async; dh + 1 otherwise
template <typename E> __host__ __device__ inline int tile_ld(int dh) {
  return dh % vec_of<E>() == 0 ? dh + vec_of<E>() : dh + 1;
}

// row stride of the score block: 16-byte aligned reads of p at any key
// multiple of the key step, whatever block_k
template <typename C> __host__ __device__ inline int score_ld(int bk) {
  return round_vec<C>(bk) + vec_of<C>();
}

template <typename T>
__host__ __device__ inline int stage_elems(int dh, int bk, int keys) {
  return round_vec<T>((bk < keys ? bk : keys) * tile_ld<T>(dh));
}

// dynamic shared memory of one CTA (the layout in the note above)
template <typename C, typename T>
__host__ __device__ inline long long smem_bytes(int rows, int dh, int bk,
                                                int keys) {
  return (long long)sizeof(C) *
             ((long long)rows * tile_ld<C>(dh) +
              (long long)rows * score_ld<C>(bk) + 4LL * rows) +
         (long long)sizeof(T) * kStages * stage_elems<T>(dh, bk, keys);
}

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* ls_out;
  T* lc_out;
  T* as_out;
  T* ac_out;
  int q_groups, sq, skv, dh, bk, kv_len, q_off, causal;
  double scale;     // dh^-0.5, rounded to the compute type where it is used
  int scheme;
  int async_copy;   // k, v rows 16-byte aligned: cp.async, else plain
  int q_aligned;    // q rows 16-byte aligned too
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one fold of a compensated pair, the scheme chosen at run time
template <typename C>
__device__ __forceinline__ void fold(int scheme, C& s, C& c, C x,
                                     long long kb) {
  switch (scheme) {
    case NAIVE: update<NAIVE>(s, c, x, kb); break;
    case KAHAN: update<KAHAN>(s, c, x, kb); break;
    case PAIRWISE: update<PAIRWISE>(s, c, x, kb); break;
    default: update<DOT2>(s, c, x, kb); break;
  }
}

// A thread's walk over the 16-byte chunks (cp.async) or the elements
// (plain loads) of a [nk, dh] sub-tile: element e = tid + n * kThreads
// sits at (row, col) = divmod(e, width); the walk steps with a carry
// instead of dividing per element (width is a runtime value).
struct Walk {
  int row, col, step_row, step_col, width;
  __device__ Walk(int tid, int w)
      : row(tid / w), col(tid % w), step_row(kThreads / w),
        step_col(kThreads % w), width(w) {}
};

// Stage item `item` of the CTA's walk into `slot`: k-block item / per_kb,
// its K sub-tiles first, then its V sub-tiles, as one cp.async group
// (nothing past the walk; plain loads land before it returns).
template <int KEYS, typename T>
__device__ __forceinline__ void stage_item(T* slot, const Args<T>& a,
                                           long long kvbase, int item,
                                           int n_items, int n_sub, int ld,
                                           const Walk& w) {
  constexpr int V = vec_of<T>();
  if (item < n_items) {
    const int per_kb = 2 * n_sub;
    const int kb = item / per_kb;
    int t = item - kb * per_kb;
    const bool is_v = t >= n_sub;
    if (is_v) t -= n_sub;
    const int key0 = kb * a.bk + t * KEYS;
    const int nk = min(KEYS, a.bk - t * KEYS);
    const T* src = (is_v ? a.v : a.k) + kvbase + (long long)key0 * a.dh;
    if (a.async_copy) {
      for (int j = w.row, c = w.col; j < nk;) {
        cp_async16(slot + j * ld + V * c, src + (long long)j * a.dh + V * c);
        j += w.step_row;
        c += w.step_col;
        if (c >= w.width) { c -= w.width; ++j; }
      }
    } else {
      for (int j = w.row, d = w.col; j < nk;) {
        slot[j * ld + d] = src[(long long)j * a.dh + d];
        j += w.step_row;
        d += w.step_col;
        if (d >= w.width) { d -= w.width; ++j; }
      }
    }
  }
  cp_async_commit();
}

// Four elements of a shared row as compute values: adjacent (16-byte
// aligned; 8-byte for a bfloat16 ring row, widened here), or in double
// the two pairs at p and p + off (each 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&x)[4],
                                      int = 2) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const Bf16f* p, Bf16f (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = Bf16f::exact(v.x);
  x[1] = Bf16f::exact(v.y);
  x[2] = Bf16f::exact(v.z);
  x[3] = Bf16f::exact(v.w);
}
__device__ __forceinline__ void load4(const Bf16* p, Bf16f (&x)[4],
                                      int = 2) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = lo_of(v.x);
  x[1] = hi_of(v.x);
  x[2] = lo_of(v.y);
  x[3] = hi_of(v.y);
}
__device__ __forceinline__ void load4(const double* p, double (&x)[4],
                                      int off = 2) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + off);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}
// KS adjacent elements (the key step of pv_tile)
template <typename C>
__device__ __forceinline__ void load_keys(const C* p, C (&x)[4]) {
  load4(p, x);
}
__device__ __forceinline__ void load_keys(const double* p, double (&x)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x[0] = v.x;
  x[1] = v.y;
}

// Scores of one K sub-tile: this thread's cells are rows ty + 16 r (r <
// TQ / 16) x keys tx + 16 c (c < KEYS / 16), each one ascending chain
// over d. VEC: q and k read four elements at a time along d.
template <int TQ, int KEYS, bool VEC, typename C, typename T>
__device__ __forceinline__ void score_tile(C* sc, int lds, const C* qs,
                                           int ldq, const T* ks, int ld,
                                           int dh, int kt, int nk, int tid) {
  constexpr int RQ = TQ / 16;
  constexpr int CK = KEYS / 16;
  const int ty = tid >> 4, tx = tid & 15;
  const C* qr[RQ];
  const T* kr[CK];
#pragma unroll
  for (int r = 0; r < RQ; ++r) qr[r] = qs + (ty + 16 * r) * ldq;
#pragma unroll
  for (int c = 0; c < CK; ++c) kr[c] = ks + min(tx + 16 * c, nk - 1) * ld;
  C s[RQ][CK];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < CK; ++c) s[r][c] = C(0.0f);
  if constexpr (VEC) {
    // (double's loads take twice the registers: a shorter unroll)
#pragma unroll (sizeof(C) == 8 ? 2 : 4)
    for (int d = 0; d < dh; d += 4) {
      C qv[RQ][4], kv[CK][4];
#pragma unroll
      for (int r = 0; r < RQ; ++r) load4(qr[r] + d, qv[r]);
#pragma unroll
      for (int c = 0; c < CK; ++c) load4(kr[c] + d, kv[c]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < CK; ++c)
            s[r][c] = s[r][c] + qv[r][e] * kv[c][e];
    }
  } else {
    for (int d = 0; d < dh; ++d) {
      C qv[RQ], kv[CK];
#pragma unroll
      for (int r = 0; r < RQ; ++r) qv[r] = qr[r][d];
#pragma unroll
      for (int c = 0; c < CK; ++c) kv[c] = to_c(kr[c][d]);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) s[r][c] = s[r][c] + qv[r] * kv[c];
    }
  }
#pragma unroll
  for (int c = 0; c < CK; ++c) {
    if (tx + 16 * c < nk) {
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        sc[(ty + 16 * r) * lds + kt + tx + 16 * c] = s[r][c];
    }
  }
}

// This thread's acc cells: 4 columns of rows rg + RG r, r < n_rows. Cell
// u's column is (u < 2 ? c0 : c1) + (u & 1): 4 quad + u (c1 = c0 + 2)
// but in double, 2 quad and 2 (quad + nq) + (u & 1); col[u] is it clamped
// to dh - 1 (the scalar loads of dh % 4 != 0 read no padding).
struct PvMap {
  int quad, rg, RG, n_rows, c0, c1;
  int col[4];
  __device__ int column(int u) const { return (u < 2 ? c0 : c1) + (u & 1); }
};

// pv[r][u] += p[row r][kt + j] * v[j][col u] over the sub-tile's keys j
// in order, for NR rows (NR >= n_rows; rows past n_rows read row rg and
// are never folded): KS p along the keys (4, 2 in double), v four
// elements at a time (VEC) or 4 scalars. Each step of KS keys runs key
// by key over every cell, so a cell's adds are KS * NR apart and none
// waits on the one before.
template <int P, int NR, bool VEC, typename C, typename T>
__device__ __forceinline__ void pv_tile(C (&pv)[P][4], const T* vs,
                                        const C* sc, int ld, int lds,
                                        int kt, int nk, const PvMap& m) {
  constexpr int KS = sizeof(C) == 8 ? 2 : 4;
  const C* pr[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r)
    pr[r] = sc + (r < m.n_rows ? m.rg + r * m.RG : m.rg) * lds + kt;
  int j = 0;
#pragma unroll 2
  for (; j + KS <= nk; j += KS) {
    C vv[KS][4], pe[NR][KS];
#pragma unroll
    for (int e = 0; e < KS; ++e) {
      const T* vj = vs + (j + e) * ld;
      if constexpr (VEC) {
        load4(vj + m.c0, vv[e], m.c1 - m.c0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[e][u] = to_c(vj[m.col[u]]);
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) load_keys(pr[r] + j, pe[r]);
#pragma unroll
    for (int e = 0; e < KS; ++e)
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          pv[r][u] = pv[r][u] + pe[r][e] * vv[e][u];
  }
  for (; j < nk; ++j) {
    C vv[4];
    const T* vj = vs + j * ld;
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = to_c(vj[VEC ? m.column(u) : m.col[u]]);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const C p = pr[r][j];
#pragma unroll
      for (int u = 0; u < 4; ++u) pv[r][u] = pv[r][u] + p * vv[u];
    }
  }
}

// pv_tile with NR the least of P, P / 2, P / 4 (P / 4 from P = 4) that
// covers n_rows.
template <int P, bool VEC, typename C, typename T>
__device__ __forceinline__ void pv_rows(C (&pv)[P][4], const T* vs,
                                        const C* sc, int ld, int lds,
                                        int kt, int nk, const PvMap& m) {
  if constexpr (P >= 4) {
    if (m.n_rows <= P / 4) {
      pv_tile<P, P / 4, VEC>(pv, vs, sc, ld, lds, kt, nk, m);
      return;
    }
  }
  if (m.n_rows <= P / 2)
    pv_tile<P, P / 2, VEC>(pv, vs, sc, ld, lds, kt, nk, m);
  else
    pv_tile<P, P, VEC>(pv, vs, sc, ld, lds, kt, nk, m);
}

// The acc fold at the end of k-block kb, then pv back to 0.
template <int S, int P, typename C>
__device__ __forceinline__ void fold_acc(C (&as)[P][4], C (&ac)[P][4],
                                         C (&pv)[P][4], const C* row_corr,
                                         const PvMap& m, long long kb) {
#pragma unroll
  for (int r = 0; r < P; ++r) {
    if (r < m.n_rows) {
      const C corr = row_corr[m.rg + r * m.RG];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        C s = as[r][u] * corr;
        C c = ac[r][u] * corr;
        update<S>(s, c, pv[r][u], kb);
        as[r][u] = s;
        ac[r][u] = c;
        pv[r][u] = C(0.0f);
      }
    }
  }
}

// The rowsum tree's levels h = H, H / 2, .., 32 below 32 * M (= the row's
// power of two p2): adds between a lane's own registers (t[m] holds j =
// lane + 32 m), every index a constant so that t stays in registers.
template <int H, int M, typename C>
__device__ __forceinline__ void tree_levels(C (&t)[M]) {
  if constexpr (H >= 32) {
    if constexpr (H < 32 * M) {
#pragma unroll
      for (int m = 0; m < H / 32; ++m) t[m] = t[m] + t[m + H / 32];
    }
    tree_levels<H / 2>(t);
  }
}

// Per row (one warp a row, RR rows of a warp at once): scale, mask, max,
// exp, the rowsum tree in registers, and the l fold; p is written back
// over the row's scores. A lane holds keys j = lane + 32 m, m < M, with M
// = max(1, p2 / 32) a constant, so no branch splits the loops: keys past
// block_k read key 0, are masked to NEG_INF (which leaves the maximum
// alone, since it starts there) and give p = 0, rowsum_tree's padding.
// In double at M = 32 (block_k 513-1024, p2 = 1024) 32 values a lane would
// not fit beside the acc registers: the 32-row tile (which takes such a
// block_k at dh up to 127) and the 16-row tile of P = 4 (dh 129-143 at
// block_k 513-520) spilled 44 bytes at 255 registers. There the max pass
// writes each masked score back over its raw one instead of holding it,
// and the exp pass reads it and folds the tree's top level (t[m] + t[m +
// 16], h = 512) as its p arrive, so a lane holds 16.
template <int TQ, int M, int RR, typename C, typename T>
__device__ __forceinline__ void softmax_rows(C* sc, int lds, C* row_m,
                                             C* row_corr, C* row_ls,
                                             C* row_lc, const Args<T>& a,
                                             int q0, int kb, int warp,
                                             int lane) {
  using N = Num<C>;
  const int bk = a.bk;
  const int key0 = kb * bk;
  const int p2 = pow2_at_least(bk);
  const C scale = C(a.scale);   // the reference's scale in the dtype
  constexpr bool kLean = sizeof(C) == 8 && M == 32;
  constexpr int MT = kLean ? M / 2 : M;
  for (int i0 = warp; i0 < TQ; i0 += kWarps * RR) {
    C t[RR][MT], mx[RR], m_new[RR], corr[RR];
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      const int i = i0 + rr * kWarps;
      C* si = sc + i * lds;
      const long long qpos = (long long)a.q_off + q0 + i;
      // (m_old >= NEG_INF, so starting the row maximum there gives the
      // reference's max(m_old, rowmax(s)))
      mx[rr] = N::neg_inf();
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int j = lane + 32 * m;
        const int kpos = key0 + j;
        C s = si[j < bk ? j : 0] * scale;
        bool valid = j < bk && kpos < a.kv_len;
        if (a.causal) valid = valid && qpos >= kpos;
        s = valid ? s : N::neg_inf();
        if constexpr (kLean) {
          if (j < bk) si[j] = s;
        } else {
          t[rr][m] = s;
        }
        mx[rr] = N::max(mx[rr], s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int rr = 0; rr < RR; ++rr)
        mx[rr] = N::max(mx[rr], N::shfl_xor(mx[rr], o));
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      const int i = i0 + rr * kWarps;
      const C m_old = row_m[i];
      m_new[rr] = N::max(m_old, mx[rr]);
      corr[rr] = N::exp(m_old - m_new[rr]);
      C* si = sc + i * lds;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int j = lane + 32 * m;
        const C s = kLean ? si[j < bk ? j : 0] : t[rr][m % MT];
        const C p = j < bk ? N::exp(s - m_new[rr]) : C(0.0f);
        if (j < bk) si[j] = p;
        if (m < MT)
          t[rr][m % MT] = p;
        else
          t[rr][m % MT] = t[rr][m % MT] + p;
      }
      // rowsum_tree: t[j] = t[j] + t[j + h] for j < h, h = p2 / 2 .. 1
      // (in the lean form h = 512 is folded above)
      tree_levels<kLean ? kMaxBk / 4 : kMaxBk / 2>(t[rr]);
    }
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
      if (h < p2) {
#pragma unroll
        for (int rr = 0; rr < RR; ++rr)
          t[rr][0] = t[rr][0] + N::shfl_down(t[rr][0], h);
      }
    }
    __syncwarp();   // every lane has read row_m
    if (lane == 0) {
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        const int i = i0 + rr * kWarps;
        C ls = row_ls[i] * corr[rr];
        C lc = row_lc[i] * corr[rr];
        fold(a.scheme, ls, lc, t[rr][0], kb);
        row_ls[i] = ls;
        row_lc[i] = lc;
        row_m[i] = m_new[rr];
        row_corr[i] = corr[rr];
      }
    }
  }
}

// softmax_rows with M = max(1, p2 / 32) for this block_k; two rows of a
// warp at once up to 8 registers a row
template <int TQ, typename C, typename T>
__device__ __forceinline__ void softmax(C* sc, int lds, C* row_m,
                                        C* row_corr, C* row_ls, C* row_lc,
                                        const Args<T>& a, int q0, int kb,
                                        int warp, int lane) {
#define REPRO_SOFTMAX(M, RR)                                                \
  softmax_rows<TQ, M, RR>(sc, lds, row_m, row_corr, row_ls, row_lc, a, q0, \
                          kb, warp, lane)
  const int p2 = pow2_at_least(a.bk);
  if (p2 <= 32) REPRO_SOFTMAX(1, 2);
  else if (p2 == 64) REPRO_SOFTMAX(2, 2);
  else if (p2 == 128) REPRO_SOFTMAX(4, 2);
  else if (p2 == 256) REPRO_SOFTMAX(8, 2);
  else if (p2 == 512) REPRO_SOFTMAX(16, 1);
  else REPRO_SOFTMAX(32, 1);
#undef REPRO_SOFTMAX
}

// T: the arrays' dtype (and the ring's); TQ: the tile's rows; P: the acc
// rows a thread holds, at most; KEYS: a sub-tile's keys. The widest dh a tile takes (128 at TQ
// 64 and 32, 256 at TQ 16) has nq = 32 or 64 column quads, so RG =
// kThreads / nq = 8 or 4 row groups of TQ / RG rows: P = 8 at TQ 64, 4 at
// TQ 32 and 16. double at TQ 16 takes P = 2 up to dh 128 (nq <= 32),
// where P = 4 spilled (a double is two registers).
template <typename T, int TQ, int P, int KEYS>
__global__ void __launch_bounds__(kThreads, 1)
kahan_flash_grid(const Args<T> a) {
  using C = typename Compute<T>::type;
  static_assert(TQ == 16 || TQ == 32 || TQ == 64, "TQ is 16, 32 or 64");
  static_assert(KEYS == 32 || KEYS == 64, "KEYS is 32 or 64");
  static_assert(P * kThreads / 32 >= TQ, "P covers a tile's rows at dh 128");
  constexpr int V = vec_of<T>();
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int rows = min(TQ, a.sq - q0);
  const int dh = a.dh, bk = a.bk;
  // four-element reads of the q, k and v rows (8-byte aligned in a
  // bfloat16 ring)
  const bool vec_d = dh % 4 == 0 && (sizeof(T) > 2 || dh % 8 == 0);

  const int ldq = tile_ld<C>(dh);
  const int ld = tile_ld<T>(dh);
  const int lds = score_ld<C>(bk);
  const int stage = stage_elems<T>(dh, bk, KEYS);
  C* qs = reinterpret_cast<C*>(smem4);       // [TQ][ldq]
  C* sc = qs + TQ * ldq;                     // [TQ][lds]
  T* ring = reinterpret_cast<T*>(sc + TQ * lds);  // kStages x [KEYS][ld]
  C* row_m = reinterpret_cast<C*>(ring + kStages * stage);
  C* row_corr = row_m + TQ;
  C* row_ls = row_corr + TQ;
  C* row_lc = row_ls + TQ;

  const long long qrow0 = (long long)bh * a.sq + q0;
  const long long kvbase = (long long)(bh / a.q_groups) * a.skv * dh;
  const int n_sub = (bk + KEYS - 1) / KEYS;
  const int n_items = a.skv / bk * 2 * n_sub;

  // the q tile (with item 0's cp.async group, or plain loads; rows past
  // sq are zero; bfloat16 widened here, 8 elements a load where q is
  // aligned), then the ring's first sub-tile
  const Walk walk(tid, a.async_copy ? dh / V : dh);
  if constexpr (std::is_same<C, T>::value) {
    if (a.async_copy && a.q_aligned) {
      for (int i = walk.row, c = walk.col; i < TQ;) {
        if (i < rows)
          cp_async16(qs + i * ldq + V * c, a.q + (qrow0 + i) * dh + V * c);
        else
          *reinterpret_cast<uint4*>(qs + i * ldq + V * c) =
              make_uint4(0u, 0u, 0u, 0u);
        i += walk.step_row;
        c += walk.step_col;
        if (c >= walk.width) { c -= walk.width; ++i; }
      }
    } else {
      for (int e = tid; e < TQ * dh; e += kThreads) {
        const int i = e / dh, d = e - (e / dh) * dh;
        qs[i * ldq + d] = i < rows ? a.q[qrow0 * dh + e] : C(0.0f);
      }
    }
  } else if (a.q_aligned && dh % V == 0) {
    const int w = dh / V;
    for (int e = tid; e < TQ * w; e += kThreads) {
      const int i = e / w, c = e - (e / w) * w;
      const uint4 r =
          i < rows ? *reinterpret_cast<const uint4*>(a.q + (qrow0 + i) * dh +
                                                     V * c)
                   : make_uint4(0u, 0u, 0u, 0u);
      float4* dst = reinterpret_cast<float4*>(qs + i * ldq + V * c);
      dst[0] = make_float4(lo_of(r.x).x, hi_of(r.x).x, lo_of(r.y).x,
                           hi_of(r.y).x);
      dst[1] = make_float4(lo_of(r.z).x, hi_of(r.z).x, lo_of(r.w).x,
                           hi_of(r.w).x);
    }
  } else {
    for (int e = tid; e < TQ * dh; e += kThreads) {
      const int i = e / dh, d = e - (e / dh) * dh;
      qs[i * ldq + d] = i < rows ? to_c(a.q[qrow0 * dh + e]) : C(0.0f);
    }
  }
  stage_item<KEYS>(ring, a, kvbase, 0, n_items, n_sub, ld, walk);
  if (tid < TQ) {
    row_m[tid] = Num<C>::neg_inf();
    row_ls[tid] = C(0.0f);
    row_lc[tid] = C(0.0f);
  }

  PvMap pm;
  {
    const int nq = (dh + 3) / 4;
    pm.quad = tid % nq;
    pm.rg = tid / nq;
    pm.RG = kThreads / nq;
    pm.n_rows = pm.rg < pm.RG ? (TQ - pm.rg + pm.RG - 1) / pm.RG : 0;
    if constexpr (sizeof(C) == 8) {
      pm.c0 = 2 * pm.quad;
      pm.c1 = 2 * (pm.quad + nq);
    } else {
      pm.c0 = 4 * pm.quad;
      pm.c1 = pm.c0 + 2;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) pm.col[u] = min(pm.column(u), dh - 1);
  }
  C a_s[P][4], a_c[P][4], pv[P][4];
#pragma unroll
  for (int r = 0; r < P; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) a_s[r][u] = a_c[r][u] = pv[r][u] = C(0.0f);

  for (int g = 0; g < n_items; ++g) {
    const int kb = g / (2 * n_sub);
    const int t = g - kb * 2 * n_sub;
    const int kt = (t < n_sub ? t : t - n_sub) * KEYS;
    const int nk = min(KEYS, bk - kt);
    const T* tile = ring + (g & 1) * stage;
    // item g has landed (this thread's copies), then everyone's are
    // visible and item g - 1's slot is free for item g + 1
    cp_async_wait_all();
    __syncthreads();
    stage_item<KEYS>(ring + ((g + 1) & 1) * stage, a, kvbase, g + 1,
                     n_items, n_sub, ld, walk);
    if (t < n_sub) {
      // 1. scores s[i][j] = sum_d q[i][d] * k[j][d], ascending d
      if (vec_d)
        score_tile<TQ, KEYS, true>(sc, lds, qs, ldq, tile, ld, dh, kt, nk,
                                   tid);
      else
        score_tile<TQ, KEYS, false>(sc, lds, qs, ldq, tile, ld, dh, kt, nk,
                                    tid);
      if (t == n_sub - 1) {
        // 2. the k-block's scores are formed: softmax and the l fold
        __syncthreads();
        softmax<TQ>(sc, lds, row_m, row_corr, row_ls, row_lc, a, q0, kb,
                    warp, lane);
      }
    } else if (pm.n_rows > 0) {
      // 3. pv[i][d] = sum_j p[i][j] * v[j][d], ascending j over the
      //    k-block, then the acc fold
      if (vec_d)
        pv_rows<P, true>(pv, tile, sc, ld, lds, kt, nk, pm);
      else
        pv_rows<P, false>(pv, tile, sc, ld, lds, kt, nk, pm);
      if (t == 2 * n_sub - 1) {
        switch (a.scheme) {
          case NAIVE: fold_acc<NAIVE>(a_s, a_c, pv, row_corr, pm, kb); break;
          case KAHAN: fold_acc<KAHAN>(a_s, a_c, pv, row_corr, pm, kb); break;
          case PAIRWISE:
            fold_acc<PAIRWISE>(a_s, a_c, pv, row_corr, pm, kb);
            break;
          default: fold_acc<DOT2>(a_s, a_c, pv, row_corr, pm, kb); break;
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int i = pm.rg + r * pm.RG;
    if (r < pm.n_rows && i < rows) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = pm.column(u);
        if (d < dh) {
          a.as_out[(qrow0 + i) * dh + d] = to_t(a_s[r][u]);
          a.ac_out[(qrow0 + i) * dh + d] = to_t(a_c[r][u]);
        }
      }
    }
  }
  if (tid < rows) {
    a.ls_out[qrow0 + tid] = to_t(row_ls[tid]);
    a.lc_out[qrow0 + tid] = to_t(row_lc[tid]);
  }
}

template <typename T, int TQ, int P, int KEYS>
int launch(const Args<T>& a, int bh, size_t smem, cudaStream_t st) {
  // opt in to more than 48 KB of dynamic shared memory, once per tile
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kahan_flash_grid<T, TQ, P, KEYS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((a.sq + TQ - 1) / TQ, bh);
  kahan_flash_grid<T, TQ, P, KEYS><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The tiles of each dtype: its two heights (the tall one first), the acc
// cells a CTA holds at most, and a sub-tile's keys at a height.
template <typename T> struct Tiles {
  static constexpr int kTall = sizeof(T) == 8 ? 32 : 64;
  static constexpr int kMaxOut = sizeof(T) == 8 ? 4096 : 8192;
  static int keys(int rows) { return sizeof(T) == 8 && rows == 32 ? 32 : 64; }
};

template <typename T>
int launch_typed(int scheme, const void* q, const void* k, const void* v,
                 void* l_s, void* l_c, void* a_s, void* a_c, int bh,
                 int q_groups, int sq, int skv, int dh, int block_k,
                 int kv_len, int q_off, int causal, double scale, int rows,
                 long long smem, cudaStream_t st) {
  using C = typename Compute<T>::type;
  using X = Tiles<T>;
  if ((rows != 16 && rows != X::kTall) ||
      rows * round4(dh) > X::kMaxOut ||
      smem != smem_bytes<C, T>(rows, dh, block_k, X::keys(rows)) ||
      smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.ls_out = static_cast<T*>(l_s);
  a.lc_out = static_cast<T*>(l_c);
  a.as_out = static_cast<T*>(a_s);
  a.ac_out = static_cast<T*>(a_c);
  a.q_groups = q_groups;
  a.sq = sq;
  a.skv = skv;
  a.dh = dh;
  a.bk = block_k;
  a.kv_len = kv_len;
  a.q_off = q_off;
  a.causal = causal;
  a.scale = scale;
  a.scheme = scheme;
  a.async_copy = dh % vec_of<T>() == 0 &&
                 ((reinterpret_cast<std::uintptr_t>(k) |
                   reinterpret_cast<std::uintptr_t>(v)) % 16) == 0;
  a.q_aligned = reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
  const size_t bytes = (size_t)smem;
  if constexpr (std::is_same<T, double>::value) {
    if (rows == 32) return launch<T, 32, 4, 32>(a, bh, bytes, st);
    if (dh <= 128) return launch<T, 16, 2, 64>(a, bh, bytes, st);
    return launch<T, 16, 4, 64>(a, bh, bytes, st);
  } else {
    if (rows == 64) return launch<T, 64, 8, 64>(a, bh, bytes, st);
    return launch<T, 16, 4, 64>(a, bh, bytes, st);
  }
}

}  // namespace

// C entry point. dtype: 0 = float32, 1 = float64, 2 = bfloat16, the
// compute dtype of every array. q: [bh, sq, dh]; k, v: [bh / q_groups,
// skv, dh]; l_s, l_c: [bh, sq]; a_s, a_c: [bh, sq, dh]; all contiguous,
// skv a multiple of block_k. The plan (rows a CTA, shared bytes) comes
// from the host's flash_plan; a plan that is not one of the kernel's (rows
// 16, or 64 for float32 and bfloat16, 32 for float64; rows * round4(dh)
// at most 8192, 4096 for float64) or whose bytes disagree with the layout
// or exceed 232448 is refused. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int kahan_flash_launch(int scheme, int dtype, const void* q,
                                  const void* k, const void* v, void* l_s,
                                  void* l_c, void* a_s, void* a_c, int bh,
                                  int q_groups, int sq, int skv, int dh,
                                  int block_k, int kv_len, int q_off,
                                  int causal, double scale, int rows,
                                  long long smem, void* stream) {
  if (scheme < NAIVE || scheme > DOT2 || dh < 1 || dh > kMaxDh ||
      block_k < 1 || block_k > kMaxBk || skv < block_k ||
      skv % block_k != 0 || q_groups < 1 || bh < 1 || bh % q_groups != 0 ||
      bh > 65535 || sq < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH(T)                                                      \
  launch_typed<T>(scheme, q, k, v, l_s, l_c, a_s, a_c, bh, q_groups, sq,    \
                  skv, dh, block_k, kv_len, q_off, causal, scale, rows,     \
                  smem, st)
  switch (dtype) {
    case 0: return REPRO_FLASH(float);
    case 1: return REPRO_FLASH(double);
    case 2: return REPRO_FLASH(Bf16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH
}

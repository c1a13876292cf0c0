// Matmul with compensated accumulation across K-blocks on Hopper.
//
// Replaces the two Pallas calls of the JAX package that share the body
// _matmul_kernel (repro/kernels/kahan_matmul.py):
//   matmul_accumulators          (:101)  grid (M/bm, N/bn, K/bk)
//   matmul_accumulators_batched  (:153)  grid (batch, M/bm, N/bn, K/bk)
// One C entry point serves both: the last grid dimension is the batch
// index, and each batch index runs the rounding sequence of a single call.
//
// What it computes: every output cell (i, j) walks K in blocks of exactly
// block_k columns, in order. Within block g it forms the block product
//   p = sum_{t in block g} a[i, t] * b[t, j]
// as ONE ascending chain of rounded products and rounded adds (p starts at
// 0), then folds it with the scheme's update from schemes.cuh:
//   update<S>(s, c, p, g)        (g = the K-block index; pairwise's fold
//                                 depends on it)
// and writes s and c once at the end. finalize (s + c) and slicing stay in
// torch (kernels/engine.py), as they stay outside Pallas in the reference.
// Only block_k and this in-block order decide the bits: every cell is
// independent of the others, so the CTA tile below is free, and a row of
// the output is the same bit for bit whatever M is and whatever the other
// rows hold. The plain version (kernels/kahan_matmul.py::matmul_plain)
// repeats the order as a loop over the block's columns, so kernel and
// plain version agree bit for bit. XLA's in-block dot_general order cannot
// be reproduced: against the reference the port holds a tolerance.
//
// Arithmetic: built with -fmad=false like the other sources, so the
// product and the add round separately; no __fmaf_rn anywhere. Operands:
// each is float32 or bfloat16 when the compute dtype is float32 (a dtype
// code per operand), float64 when it is float64, bfloat16 when it is
// bfloat16, and is widened to the compute dtype when it is staged into
// shared memory. Widening is exact, so the bits equal those of operands
// promoted first, and bf16 weights are read as they are stored, never
// copied. The caller pads N and K to its blocks with zeros and passes M as
// it is; the kernel masks the rows and columns of its own tile past M and
// N.
//
// bfloat16 compute (T = Bf16 of schemes.cuh): every product, add and every
// op of the scheme's fold is computed in float and rounded to bfloat16
// once (with -ftz=true, a float result below 2^-126 is a zero of its sign
// before it is rounded), at exactly the sites where the plain version
// rounds: that is how torch computes a bfloat16 op, and it is not what the
// native bf16 add and multiply do (they round the exact result once, which
// differs from float-then-bfloat16 where the float result lies on a
// bfloat16 midpoint). Values are held as floats (C = Compute<T> = Bf16f:
// the bfloat16 bits in the upper half), and each rounding is one
// cvt.rn.bf16x2.f32 (F2FP), so no operand is widened again after it enters
// shared memory or registers: the stages, p, and the fold's s and c hold
// Bf16f, and only s_out and c_out are written as bfloat16 bits. The tile
// plan, stages and shared-memory budget are float32's. Each term then
// costs four instructions (FMUL, F2FP, FADD, F2FP) against float32's two,
// so bfloat16 reaches at most half of float32's mul+add ceiling.
//
// Two paths, chosen by M; both give the bits above.
//
// M > 8 (chunks, prefill and B6; kahan_matmul_grid). What bounds it is
// the operations. The fixed in-block chain (a rounded product and a rounded
// add per term, in ascending order) rules out tensor cores and fma, so the
// ceiling is the CUDA cores issuing one multiply and one add per term:
// 2 * M * N * K operations at about 33.5 TFLOP/s, half the card's 67
// TFLOP/s fma rate. What the design does about what held the earlier
// 64 x 64 tile (one CTA over all of K) far below that:
// - too few CTAs (32 at M 64, N 2048): a tile's K-blocks are split over a
//   thread-block cluster of `split` CTAs (split = min(steps, 8), lowered
//   until tiles * split is at most twice the SM count; 1, and no cluster,
//   where the tiles alone fill the card). In round r the CTA of rank q
//   forms p of K-block r * split + q over the whole tile and leaves it in
//   its shared memory; after a cluster barrier rank q folds its slice of
//   the tile's cells, reading each live K-block's p from its owner's shared
//   memory (distributed shared memory) in the order g = 0, 1, ..., and keeps
//   s and c of the slice in its own shared memory across rounds. One
//   launch, no workspace in device memory, no atomics. At split 1 each
//   thread folds its own cells from registers.
// - a slow CTA: only p lives in the chain's registers (s and c sit in
//   shared memory, touched once per K-block); each thread owns RM x 4 cells
//   (rows ty + 16 * i, four adjacent columns; 8 x 4 at TM 128) and reads
//   them with vector shared loads, four k at a time, the loop over a
//   stage's kTileK columns unrolled whole. Operands are widened once, where
//   they enter shared memory, not by each of the 16 threads that read an
//   element: a stage is loaded from device memory into registers (16-byte
//   vector loads of float32, 8-byte of bf16) while the stage before it is
//   multiplied, then widened and stored into the other of two shared
//   buffers; one barrier a stage. This replaces a ring of cp.async copies
//   that kept bf16 in shared memory and widened it where it was read: at
//   M 64 the widening then took a fifth of the chain's instructions, and
//   that ring measured slower on every shape.
// - masked rows: the tile has TM = 32, 64 or 128 rows by M (128 from M =
//   256), so a 32-token chunk computes no masked half.
// Past M, N and the K-block the stages are zero-filled, and the chain runs
// whole stages: a term +0 * +0 = +0 leaves p's bits as they are (p starts
// at +0, and a rounded sum is -0 only when both terms are). Four elements
// that are not aligned for one vector load, or not all in range, are read
// one by one into the same registers.
// float64 has its own tile, sized by the FP64 pipe (64 lanes an SM, half
// float32's) and by shared memory (its elements are twice as wide):
// - TM = 64 rows (32 up to M 32) by 64 columns, 4 x 4 cells a thread, whose
//   four columns are two pairs 32 apart (2 tx, 2 tx + 1, 32 + 2 tx, 33 +
//   2 tx): each double2 read of B by a warp is then 256 contiguous bytes,
//   and a k-step reads 8 double2 for 32 DMUL and 32 DADD;
// - stages of 32 K columns that need no widening, so they are copied
//   straight into shared memory by a ring of kF64Ring stages of 16-byte
//   cp.async copies (element loads where a pair is not aligned or not all
//   in range), two stages ahead of the chain;
// - at TM 64 only one CTA fits an SM (166,912 B), so the instantiation is
//   bounded at one CTA an SM (up to 255 registers; it takes 138 for its
//   4 x 4 doubles of p and of each operand quad) and the cluster split is
//   lowered until the tiles fill the SMs once, not twice.
//
// M <= 8 (decode and the batch-1 body; kahan_matmul_rows): no row is
// padded and no thread works on a row past M. What bounds it is the bytes
// of B, read once (2 * K * N for bf16 weights: 8 MB for a 2048 x 2048
// projection, 2.5 us at 3.35 TB/s), and, behind them, the chain of
// block_k dependent rounded adds that forms one block product (512 adds
// of 4 cycles, about 1 us). There are only M * N * steps such chains
// (8192 for a 2048 x 2048 projection at M = 1; steps = K / block_k), too
// few threads to keep the memory busy from registers, so:
// - a CTA owns `cols` output columns for all M rows and all of K, so that
//   the fold stays inside it: 16 columns (128 CTAs at N = 2048), or 32
//   where that still gives kRowWideCtas CTAs (N = 8192);
// - its groups of `cols` threads take different K-blocks of those
//   columns at once (groups = min(steps, 16, 256 / cols)). A thread keeps
//   the p of its column's M rows in registers and forms them as the one
//   ascending chain of block_k steps. When the round's K-blocks are
//   formed, each group writes its p to shared memory, and after a barrier
//   group 0 folds them with update<S> in the order g = 0, 1, ... and keeps
//   s and c in registers; more K-blocks than groups are walked in rounds
//   of `groups`, each folded after its barrier, so the fold order is that
//   of the plain loop;
// - B and A reach shared memory through a ring of kRowStages stages of
//   16-byte cp.async copies (a stage holds tile_k rows of every group's
//   K-block: B as stored, widened where it is read; bfloat16 to Bf16f by
//   a shift), issued by every
//   thread of the CTA kRowStages - 1 tiles ahead of the chain. A stage
//   holds up to kRowStageBytes (16 KB) of B, so a CTA keeps up to 48 KB of
//   B in flight: about 6 MB over 128 CTAs, more than the 2-3 MB that the
//   card's memory rate times its latency asks for. At N = 2048 with 4
//   K-blocks that is three of the CTA's four tiles issued before the
//   first add; the chain of each tile hides behind the next tiles' loads.
// At M = 1 a projection has only two warps per SM (one chain each per
// column and K-block), so what is left is their issue rate: the chain
// loop is unrolled 16 deep so that its shared-memory reads run ahead of
// the adds.
// Operands whose rows are not 16-byte aligned are staged with plain loads
// (the same ring, not overlapped): the engine pads N and K to its blocks,
// so at the model's widths every copy is a cp.async.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "schemes.cuh"

namespace {

using namespace repro_schemes;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- M > 8: K-blocks split over a cluster, folded in order ---------------

constexpr int kThreads = 256;   // 16 x 16 threads, each RM x kRegN cells
constexpr int kTileN = 64;      // columns of a tile
constexpr int kRegN = 4;        // columns a thread owns
constexpr int kTileK = 64;      // K columns a stage holds (float, Bf16f)
constexpr int kF64TileK = 32;   // K columns a stage holds (double)
constexpr int kF64Ring = 3;     // cp.async stages of the double tile
constexpr int kMaxSplit = 8;    // CTAs of a cluster (portable limit)

// K columns of a stage, and stages, for the compute type C
template <typename C> __host__ __device__ constexpr int tile_k() {
  return sizeof(C) == 8 ? kF64TileK : kTileK;
}
template <typename C> __host__ __device__ constexpr int n_stages() {
  return sizeof(C) == 8 ? kF64Ring : 2;
}

// padded row of an A stage, in elements of the compute type: 16 bytes
// past the stage's K columns keep rows 16-byte aligned and put the two
// adjacent rows a warp reads in different banks
template <typename C> __host__ __device__ constexpr int a_ld() {
  return tile_k<C>() + 16 / sizeof(C);
}

// CTAs of a tile height an SM: two, but one for the 64-row double tile,
// whose shared memory leaves room for only one (its launch bounds follow)
template <typename C> __host__ __device__ constexpr int ctas_per_sm(int tm) {
  return sizeof(C) == 8 && tm == 64 ? 1 : 2;
}

// The column (of the tile's kTileN) of a thread's cell j: four adjacent
// ones; in double two pairs kTileN / 2 apart, so that the double2 reads of
// a warp's 16 threads of one row cover 256 contiguous bytes
template <typename C> __device__ __forceinline__ int col_of(int tx, int j) {
  if constexpr (sizeof(C) == 8)
    return 2 * tx + j + (j < 2 ? 0 : kTileN / 2 - 2);
  else
    return tx * kRegN + j;
}

// A thread's four elements of a stage row as compute values: four adjacent
// ones in one vector load, or in double the pairs at p and p + off.
template <typename C> struct Quad;
template <> struct Quad<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p, int) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float operator[](int j) const {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};
template <> struct Quad<Bf16f> {
  float4 v;
  __device__ __forceinline__ void load(const Bf16f* p, int) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ Bf16f operator[](int j) const {
    return Bf16f::exact(j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w);
  }
};
template <> struct Quad<double> {
  double2 v, w;
  __device__ __forceinline__ void load(const double* p, int off) {
    v = *reinterpret_cast<const double2*>(p);
    w = *reinterpret_cast<const double2*>(p + off);
  }
  __device__ __forceinline__ double operator[](int j) const {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? w.x : w.y;
  }
};
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(Bf16f* p, const Bf16f (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
}

// Four adjacent operand elements as read from device memory (one vector
// load where they are aligned and all in range), kept as stored until they
// are widened into shared memory (float and Bf16f stages).
template <typename X> struct Raw4;
template <> struct Raw4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void set(int j, const float* p, bool ok) {
    const float x = ok ? *p : 0.0f;
    if (j == 0) v.x = x;
    else if (j == 1) v.y = x;
    else if (j == 2) v.z = x;
    else v.w = x;
  }
  __device__ __forceinline__ void widen4(float (&x)[4]) const {
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <> struct Raw4<__nv_bfloat16> {
  uint2 v;   // element 2q in the low half of word q
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void set(int j, const __nv_bfloat16* p,
                                     bool ok) {
    const unsigned x = ok ? __bfloat16_as_ushort(*p) : 0u;
    unsigned& word = j < 2 ? v.x : v.y;
    word = j % 2 ? (word & 0xffffu) | (x << 16) : (word & 0xffff0000u) | x;
  }
  // bf16 -> float is exact: the bits move to the top half
  __device__ __forceinline__ void widen4(float (&x)[4]) const {
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  __device__ __forceinline__ void widen4(Bf16f (&x)[4]) const {
    float f[4];
    widen4(f);
    for (int j = 0; j < 4; ++j) x[j] = Bf16f::exact(f[j]);
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct GridWalk {
  int m, n, k, block_k, steps, split, rank, tiles_per_block, n_tiles;
  int m0, n0;
  bool vec_a, vec_b;   // A rows / B rows may be read as vectors
};

// The quads of stage tile t (round t / tiles_per_block, columns [kt *
// kTileK, + kTileK) of K-block round * split + rank) that this thread
// moves through its registers (float and Bf16f stages): A's rows are 16
// quads of k, B's 16 quads of columns; zeros past M, N and the K-block.
template <int TM, typename TA, typename TB>
struct StageRegs {
  static constexpr int kQA = TM * (kTileK / 4) / kThreads;
  static constexpr int kQB = kTileK * (kTileN / 4) / kThreads;
  Raw4<TA> a[kQA];
  Raw4<TB> b[kQB];

  __device__ __forceinline__ void fetch(const TA* ga, const TB* gb, int t,
                                        const GridWalk& w) {
    const int r = t / w.tiles_per_block;
    const long long g = (long long)r * w.split + w.rank;
    if (t >= w.n_tiles || g >= w.steps) return;
    const int k_in = (t - r * w.tiles_per_block) * kTileK;
    const int rows = min(kTileK, w.block_k - k_in);   // K columns of the tile
    const long long k0 = g * w.block_k + k_in;
#pragma unroll
    for (int u = 0; u < kQA; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int i = e / (kTileK / 4), kq = 4 * (e % (kTileK / 4));
      const int row = w.m0 + i;
      const TA* src = ga + (long long)row * w.k + k0 + kq;
      if (w.vec_a && row < w.m && kq + 4 <= rows) {
        a[u].load(src);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[u].set(j, src + j, row < w.m && kq + j < rows);
      }
    }
#pragma unroll
    for (int u = 0; u < kQB; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int kk = e / (kTileN / 4), jq = 4 * (e % (kTileN / 4));
      const int col = w.n0 + jq;
      const TB* src = gb + (k0 + kk) * w.n + col;
      if (w.vec_b && kk < rows && col + 4 <= w.n) {
        b[u].load(src);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[u].set(j, src + j, kk < rows && col + j < w.n);
      }
    }
  }

  // widen into the stage buffers: A as [TM][a_ld], B as [kTileK][kTileN]
  template <typename C>
  __device__ __forceinline__ void store(C* as, C* bs) const {
#pragma unroll
    for (int u = 0; u < kQA; ++u) {
      const int e = threadIdx.x + u * kThreads;
      C x[4];
      a[u].widen4(x);
      store4(as + (e / (kTileK / 4)) * a_ld<C>() + 4 * (e % (kTileK / 4)), x);
    }
#pragma unroll
    for (int u = 0; u < kQB; ++u) {
      const int e = threadIdx.x + u * kThreads;
      C x[4];
      b[u].widen4(x);
      store4(bs + (e / (kTileN / 4)) * kTileN + 4 * (e % (kTileN / 4)), x);
    }
  }
};
struct NoStageRegs {};

// Copy stage tile t of the walk into ring slot t % kF64Ring (double, which
// needs no widening): A as [TM][a_ld], B as [kF64TileK][kTileN], in 16-byte
// cp.async copies of two elements; a pair that is not aligned, or not all
// in range, by element loads, zeros past M, N and the K-block. Always
// commits one group.
template <int TM>
__device__ __forceinline__ void copy_stage(double* ring, const double* ga,
                                           const double* gb, int t,
                                           const GridWalk& w) {
  constexpr int TK = kF64TileK, LDA = a_ld<double>();
  const int r = t / w.tiles_per_block;
  const long long g = (long long)r * w.split + w.rank;
  if (t < w.n_tiles && g < w.steps) {
    double* as = ring + (t % kF64Ring) * (TM * LDA + TK * kTileN);
    double* bs = as + TM * LDA;
    const int k_in = (t - r * w.tiles_per_block) * TK;
    const int rows = min(TK, w.block_k - k_in);   // K columns of the tile
    const long long k0 = g * w.block_k + k_in;
#pragma unroll
    for (int u = 0; u < TM * (TK / 2) / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int i = e / (TK / 2), kq = 2 * (e % (TK / 2));
      const int row = w.m0 + i;
      const double* src = ga + (long long)row * w.k + k0 + kq;
      double* dst = as + i * LDA + kq;
      if (w.vec_a && row < w.m && kq + 2 <= rows) {
        cp_async16(dst, src);
      } else {
        dst[0] = row < w.m && kq < rows ? src[0] : 0.0;
        dst[1] = row < w.m && kq + 1 < rows ? src[1] : 0.0;
      }
    }
#pragma unroll
    for (int u = 0; u < TK * (kTileN / 2) / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int kk = e / (kTileN / 2), jq = 2 * (e % (kTileN / 2));
      const int col = w.n0 + jq;
      const double* src = gb + (k0 + kk) * w.n + col;
      double* dst = bs + kk * kTileN + jq;
      if (w.vec_b && kk < rows && col + 2 <= w.n) {
        cp_async16(dst, src);
      } else {
        dst[0] = kk < rows && col < w.n ? src[0] : 0.0;
        dst[1] = kk < rows && col + 1 < w.n ? src[1] : 0.0;
      }
    }
  }
  cp_async_commit();
}

// Fold the round's block products into the slice [lo, hi) of the tile's
// cells: K-block r * split + jj lies in the shared memory of rank jj.
template <int S, typename C>
__device__ __forceinline__ void fold_slice(C* s_sh, C* c_sh, C* p_sh, int lo,
                                           int hi, int live, long long g0) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    C s = s_sh[e - lo], c = c_sh[e - lo];
    for (int jj = 0; jj < live; ++jj)
      update<S>(s, c, cluster.map_shared_rank(p_sh, jj)[e], g0 + jj);
    s_sh[e - lo] = s;
    c_sh[e - lo] = c;
  }
}

template <int S, typename C, int RM>
__device__ __forceinline__ void fold_own(C* s_sh, C* c_sh,
                                         const C (&p)[RM][kRegN], int ty,
                                         int tx, long long g) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < kRegN; ++j) {
      const int e = (ty + 16 * i) * kTileN + col_of<C>(tx, j);
      update<S>(s_sh[e], c_sh[e], p[i][j], g);
    }
}

// bytes of dynamic shared memory: the stages of A and B in the compute
// type, p of the tile (split > 1), and s and c of the CTA's slice of the
// tile's cells
template <typename C, int TM>
size_t grid_smem(int split) {
  const int cells = TM * kTileN;
  const int slice = (cells + split - 1) / split;
  return n_stages<C>() * (size_t)(TM * a_ld<C>() + tile_k<C>() * kTileN)
             * sizeof(C)
         + (split > 1 ? (size_t)cells * sizeof(C) : 0)
         + 2 * (size_t)slice * sizeof(C);
}

// Bounded so that ctas_per_sm CTAs fit an SM: two (at most 128 registers a
// thread, where the grid has them: gate/up, B6 and down at M 64 do), one
// for the 64-row double tile.
template <typename T, typename TA, typename TB, int TM>
__global__ void __launch_bounds__(
    kThreads, ctas_per_sm<typename Compute<T>::type>(TM))
kahan_matmul_grid(const TA* __restrict__ a, const TB* __restrict__ b,
                  T* __restrict__ s_out, T* __restrict__ c_out, int m, int n,
                  int k, int block_k, int scheme, int split, int vec_a,
                  int vec_b) {
  using C = typename Compute<T>::type;
  constexpr bool kRing = sizeof(C) == 8;   // double: the cp.async ring
  constexpr int RM = TM / 16;
  constexpr int TK = tile_k<C>();
  constexpr int LDA = a_ld<C>();
  constexpr int kStageElems = TM * LDA + TK * kTileN;
  extern __shared__ __align__(16) unsigned char smem[];
  C* stages = reinterpret_cast<C*>(smem);   // [n_stages][A stage, B stage]
  C* p_sh = stages + n_stages<C>() * kStageElems;
  constexpr int cells = TM * kTileN;
  C* s_sh = p_sh + (split > 1 ? cells : 0);
  const int slice = (cells + split - 1) / split;
  C* c_sh = s_sh + slice;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  GridWalk w;
  w.m = m; w.n = n; w.k = k; w.block_k = block_k;
  w.steps = k / block_k;
  w.split = split;
  w.rank = blockIdx.z % split;   // the cluster is (1, 1, split)
  w.tiles_per_block = (block_k + TK - 1) / TK;
  w.n_tiles = (w.steps + split - 1) / split * w.tiles_per_block;
  w.m0 = blockIdx.y * TM;
  w.n0 = blockIdx.x * kTileN;
  w.vec_a = vec_a; w.vec_b = vec_b;
  const long long batch = blockIdx.z / split;
  a += batch * m * (long long)k;
  b += batch * k * (long long)n;
  s_out += batch * m * (long long)n;
  c_out += batch * m * (long long)n;

  const int lo = w.rank * slice;
  const int hi = min(cells, lo + slice);
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    s_sh[e - lo] = C(0.0f);
    c_sh[e - lo] = C(0.0f);
  }
  C p[RM][kRegN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < kRegN; ++j) p[i][j] = C(0.0f);

  // float and Bf16f: stage t lives in buffer t % 2; the registers carry
  // stage t + 1 while stage t is multiplied, so its loads from device
  // memory overlap the chain. double: the ring holds stages t .. t + 2.
  std::conditional_t<kRing, NoStageRegs, StageRegs<TM, TA, TB>> regs;
  if constexpr (kRing) {
#pragma unroll
    for (int t = 0; t < kF64Ring - 1; ++t) copy_stage<TM>(stages, a, b, t, w);
  } else {
    regs.fetch(a, b, 0, w);
    regs.store(stages, stages + TM * LDA);
    regs.fetch(a, b, 1, w);
  }
  for (int t = 0; t < w.n_tiles; ++t) {
    if constexpr (kRing) {
      cp_async_wait<kF64Ring - 2>();   // this thread's copies of stage t
      __syncthreads();   // everyone's; stage t - 1's slot consumed
      copy_stage<TM>(stages, a, b, t + kF64Ring - 1, w);
    } else {
      __syncthreads();   // stage t stored; stage t - 1's buffer consumed
    }
    const int r = t / w.tiles_per_block;
    const long long g = (long long)r * split + w.rank;
    if (g < w.steps) {
      // a thread's rows ty + 16 * i and columns col_of(tx, j), four k at a
      // time
      const C* as = stages + (t % n_stages<C>()) * kStageElems + ty * LDA;
      const C* bs = stages + (t % n_stages<C>()) * kStageElems + TM * LDA
                    + col_of<C>(tx, 0);
#pragma unroll
      for (int k4 = 0; k4 < TK; k4 += 4) {
        Quad<C> af[RM], bf[4];
#pragma unroll
        for (int i = 0; i < RM; ++i) af[i].load(as + 16 * i * LDA + k4, 2);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          bf[kk].load(bs + (k4 + kk) * kTileN, kTileN / 2);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < kRegN; ++j)
              p[i][j] = p[i][j] + af[i][kk] * bf[kk][j];
      }
    }
    if constexpr (!kRing) {
      if (t + 1 < w.n_tiles) {
        C* next = stages + ((t + 1) % 2) * kStageElems;
        regs.store(next, next + TM * LDA);
        regs.fetch(a, b, t + 2, w);
      }
    }
    if (t - r * w.tiles_per_block < w.tiles_per_block - 1) continue;
    // the round's block products are formed: fold them in K-block order
    if (split == 1) {
      switch (scheme) {
        case NAIVE: fold_own<NAIVE>(s_sh, c_sh, p, ty, tx, g); break;
        case KAHAN: fold_own<KAHAN>(s_sh, c_sh, p, ty, tx, g); break;
        case PAIRWISE: fold_own<PAIRWISE>(s_sh, c_sh, p, ty, tx, g); break;
        default: fold_own<DOT2>(s_sh, c_sh, p, ty, tx, g); break;
      }
    } else {
      if (r > 0) cluster_wait();    // the last round's readers are done
      if (g < w.steps) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < kRegN; ++j)
            p_sh[(ty + 16 * i) * kTileN + col_of<C>(tx, j)] = p[i][j];
      }
      cluster_arrive();
      cluster_wait();               // every live rank's p is written
      const int live = min(split, w.steps - r * split);
      const long long g0 = (long long)r * split;
#define REPRO_FOLD_SLICE(S) fold_slice<S>(s_sh, c_sh, p_sh, lo, hi, live, g0)
      switch (scheme) {
        case NAIVE: REPRO_FOLD_SLICE(NAIVE); break;
        case KAHAN: REPRO_FOLD_SLICE(KAHAN); break;
        case PAIRWISE: REPRO_FOLD_SLICE(PAIRWISE); break;
        default: REPRO_FOLD_SLICE(DOT2); break;
      }
#undef REPRO_FOLD_SLICE
      cluster_arrive();             // this CTA's reads are done
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kRegN; ++j) p[i][j] = C(0.0f);
  }
  if constexpr (kRing) cp_async_wait<0>();
  if (split == 1)
    __syncthreads();                // the slice is every thread's cells
  else
    cluster_wait();                 // no rank reads this p_sh any more
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    const int row = w.m0 + e / kTileN, col = w.n0 + e % kTileN;
    if (row < m && col < n) {
      s_out[(long long)row * n + col] = to_t(s_sh[e - lo]);
      c_out[(long long)row * n + col] = to_t(c_sh[e - lo]);
    }
  }
}

// ---- M <= 8: K-blocks in parallel, folded in order (see the note above) --

constexpr int kRowThreads = 256;      // at most, = groups * cols
constexpr int kRowMaxGroups = 16;     // K-blocks formed at once per CTA
constexpr int kRowStages = 4;         // cp.async ring depth
constexpr int kRowStageBytes = 16384; // B bytes a stage aims at
constexpr int kRowWideCtas = 256;     // 32 columns per CTA from this many

template <typename T> __device__ __forceinline__ T widen(float x) { return T(x); }
template <typename T> __device__ __forceinline__ T widen(double x) { return T(x); }
template <typename T> __device__ __forceinline__ T widen(__nv_bfloat16 x) {
  return T(__bfloat162float(x));
}
// bf16 -> Bf16f: the bits shifted to the top half, where they are read
template <> __device__ __forceinline__ Bf16f widen<Bf16f>(__nv_bfloat16 x) {
  return Bf16f::exact(
      __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16));
}

// Stage tile t of the CTA's walk (round r = t / tiles_per_block, rows
// [kt * tile_k, + rows) of each live group's K-block r * groups + jj):
// B as [jj][kk][cols], A as [jj][i][kk]. Always commits one group.
template <typename TA, typename TB>
__device__ __forceinline__ void stage_row_tile(
    TA* a_sh, TB* b_sh, const TA* a, const TB* b, int t, int m, int n,
    int k, int block_k, int steps, int groups, int lg_cols, int tile_k,
    int lg_tile_k, int tiles_per_block, int n_tiles, int n0, bool vec_a,
    bool vec_b) {
  if (t < n_tiles) {
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int r = t / tiles_per_block;
    const int k_in = (t - r * tiles_per_block) * tile_k;
    const int rows = min(tile_k, block_k - k_in);
    const int live = min(groups, steps - r * groups);
    const long long k_base = (long long)r * groups * block_k + k_in;
    const int slot = t % kRowStages;
    const int cols = 1 << lg_cols;
    TB* bs = b_sh + (slot * groups * tile_k << lg_cols);
    TA* as = a_sh + slot * groups * m * tile_k;
    if (vec_b) {
      constexpr int kVec = 16 / sizeof(TB);
      constexpr int kLgVec = kVec == 8 ? 3 : kVec == 4 ? 2 : 1;
      const int lg_chunks = lg_cols - kLgVec;      // per row: 2 to 16
      for (int e = tid; e < (live * tile_k) << lg_chunks; e += nthreads) {
        const int q = e & ((1 << lg_chunks) - 1), row = e >> lg_chunks;
        const int kk = row & (tile_k - 1), jj = row >> lg_tile_k;
        const int col = n0 + q * kVec;
        if (kk < rows && col < n)
          cp_async16(bs + (row << lg_cols) + q * kVec,
                     b + (k_base + (long long)jj * block_k + kk) * n + col);
      }
    } else {
      for (int e = tid; e < (live * tile_k) << lg_cols; e += nthreads) {
        const int q = e & (cols - 1), row = e >> lg_cols;
        const int kk = row & (tile_k - 1), jj = row >> lg_tile_k;
        if (kk < rows && n0 + q < n)
          bs[e] = b[(k_base + (long long)jj * block_k + kk) * n + n0 + q];
      }
    }
    if (vec_a) {
      constexpr int kVec = 16 / sizeof(TA);
      const int chunks = tile_k / kVec;             // tile_k >= 8 >= kVec
      for (int e = tid; e < live * m * chunks; e += nthreads) {
        const int q = e % chunks, line = e / chunks;  // line = jj * m + i
        const int i = line % m, jj = line / m;
        if (q * kVec < rows)
          cp_async16(as + line * tile_k + q * kVec,
                     a + (long long)i * k + k_base + (long long)jj * block_k
                         + q * kVec);
      }
    } else {
      for (int e = tid; e < live * m * tile_k; e += nthreads) {
        const int kk = e & (tile_k - 1), line = e >> lg_tile_k;
        const int i = line % m, jj = line / m;
        if (kk < rows)
          as[e] = a[(long long)i * k + k_base + (long long)jj * block_k + kk];
      }
    }
  }
  cp_async_commit();
}

// Bounded at two CTAs an SM (128 registers): with the thread count alone
// ptxas aimed at 48 or 64 registers and spilled a few bytes in some
// instantiations (dot2 at M 1 in bfloat16, M 3-4 in float64 and float32).
template <int S, typename T, typename TA, typename TB, int MR>
__global__ void __launch_bounds__(kRowThreads, 2)
kahan_matmul_rows(const TA* __restrict__ a, const TB* __restrict__ b,
                  T* __restrict__ s_out, T* __restrict__ c_out, int m, int n,
                  int k, int block_k, int groups, int lg_cols, int tile_k,
                  int lg_tile_k, int vec_a, int vec_b) {
  using C = typename Compute<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = 1 << lg_cols;
  TB* b_sh = reinterpret_cast<TB*>(smem);
  TA* a_sh = reinterpret_cast<TA*>(
      smem + ((size_t)kRowStages * groups * tile_k * sizeof(TB) << lg_cols));
  C* p_sh = reinterpret_cast<C*>(
      reinterpret_cast<unsigned char*>(a_sh)
      + (size_t)kRowStages * groups * m * tile_k * sizeof(TA));

  const int col = threadIdx.x & (cols - 1);
  const int j = threadIdx.x >> lg_cols;        // this thread's group
  const int n0 = blockIdx.x << lg_cols;
  const bool live_col = n0 + col < n;
  const long long batch = blockIdx.y;
  a += batch * m * (long long)k;
  b += batch * k * (long long)n;
  s_out += batch * m * (long long)n;
  c_out += batch * m * (long long)n;

  const int steps = k / block_k;
  const int tiles_per_block = (block_k + tile_k - 1) / tile_k;
  const int n_tiles = (steps + groups - 1) / groups * tiles_per_block;

  C p[MR], s[MR], c[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) { p[i] = C(0.0f); s[i] = C(0.0f); c[i] = C(0.0f); }

  for (int t = 0; t < kRowStages - 1; ++t)
    stage_row_tile(a_sh, b_sh, a, b, t, m, n, k, block_k, steps, groups,
                   lg_cols, tile_k, lg_tile_k, tiles_per_block, n_tiles, n0,
                   vec_a, vec_b);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kRowStages - 2>();   // this thread's copies of tile t
    __syncthreads();                   // everyone's; tile t - 1 consumed
    stage_row_tile(a_sh, b_sh, a, b, t + kRowStages - 1, m, n, k, block_k,
                   steps, groups, lg_cols, tile_k, lg_tile_k, tiles_per_block,
                   n_tiles, n0, vec_a, vec_b);
    const int r = t / tiles_per_block;
    const int kt = t - r * tiles_per_block;
    const int g = r * groups + j;
    if (g < steps && live_col) {
      const int rows = min(tile_k, block_k - kt * tile_k);
      const int slot = t % kRowStages;
      const TB* bs = b_sh + ((slot * groups + j) * tile_k << lg_cols) + col;
      const TA* as = a_sh + (slot * groups + j) * m * tile_k;
#pragma unroll 16
      for (int kk = 0; kk < rows; ++kk) {
        const C bv = widen<C>(bs[kk << lg_cols]);
#pragma unroll
        for (int i = 0; i < MR; ++i)
          if (i < m) p[i] = p[i] + widen<C>(as[i * tile_k + kk]) * bv;
      }
    }
    if (kt == tiles_per_block - 1) {   // the round's block products formed
      if (g < steps && live_col) {
#pragma unroll
        for (int i = 0; i < MR; ++i)
          if (i < m) p_sh[((j * m + i) << lg_cols) + col] = p[i];
      }
      __syncthreads();
      if (j == 0 && live_col) {
        const int live = min(groups, steps - r * groups);
        for (int jj = 0; jj < live; ++jj) {
#pragma unroll
          for (int i = 0; i < MR; ++i)
            if (i < m)
              update<S>(s[i], c[i], p_sh[((jj * m + i) << lg_cols) + col],
                        (long long)r * groups + jj);
        }
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) p[i] = C(0.0f);
    }
  }
  cp_async_wait<0>();

  if (j == 0 && live_col) {
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      if (i >= m) continue;
      s_out[(long long)i * n + n0 + col] = to_t(s[i]);
      c_out[(long long)i * n + n0 + col] = to_t(c[i]);
    }
  }
}

struct Args {
  const void* a;
  const void* b;
  void* s;
  void* c;
  int batch, m, n, k, block_k;
  cudaStream_t stream;
};

// The M > 8 path's plan: TM rows a tile (32 up to M 32, 128 from M 256,
// else 64; float64 32 up to M 32, else 64) and the cluster size `split`
// (K-blocks formed at once per tile): min(steps, kMaxSplit), lowered until
// tiles * split is at most ctas_per_sm times the SM count (twice, once for
// the 64-row float64 tile) and batch * split fits grid z.
struct GridPlan {
  int tm, split;
};

template <typename T>
GridPlan grid_plan(int batch, int m, int n, int k, int block_k) {
  using C = typename Compute<T>::type;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess)
      sms = 132;
  }
  GridPlan plan;
  plan.tm = m <= 32 ? 32 : sizeof(C) == 8 || m < 256 ? 64 : 128;
  const long long tiles = (long long)((n + kTileN - 1) / kTileN)
                          * ((m + plan.tm - 1) / plan.tm) * batch;
  const long long slots = (long long)ctas_per_sm<C>(plan.tm) * sms;
  const int steps = k / block_k;
  plan.split = steps < kMaxSplit ? steps : kMaxSplit;
  while (plan.split > 1 && (tiles * plan.split > slots
                            || (long long)batch * plan.split > 65535))
    --plan.split;
  return plan;
}

// The plans the M > 8 path has for a call, which a caller may force: a
// tile height of the compute dtype (32, 64 or 128 rows; float64 32 or 64)
// and 1 <= split <= min(steps, kMaxSplit) with batch * split in grid z.
template <typename T>
bool plan_fits(const GridPlan& plan, int batch, int steps) {
  const bool rows = plan.tm == 32 || plan.tm == 64
                    || (plan.tm == 128 && sizeof(typename Compute<T>::type) != 8);
  return rows && plan.split >= 1 && plan.split <= kMaxSplit
         && plan.split <= steps && (long long)batch * plan.split <= 65535;
}

template <typename T, typename TA, typename TB, int TM>
int launch_tile(int scheme, int split, const Args& x) {
  using C = typename Compute<T>::type;
  // a vector read moves four elements (float, Bf16f stages) or two
  // (double); it wants them aligned
  constexpr int kVec = sizeof(C) == 8 ? 2 : 4;
  const int vec_a = reinterpret_cast<uintptr_t>(x.a) % (kVec * sizeof(TA)) == 0
                    && x.k % kVec == 0 && x.block_k % kVec == 0;
  const int vec_b = reinterpret_cast<uintptr_t>(x.b) % (kVec * sizeof(TB)) == 0
                    && x.n % kVec == 0;
  const size_t smem = grid_smem<C, TM>(split);
  auto kern = kahan_matmul_grid<T, TA, TB, TM>;
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((x.n + kTileN - 1) / kTileN, (x.m + TM - 1) / TM,
                     x.batch * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = x.stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = split;
  cfg.attrs = &attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const TA*>(x.a), static_cast<const TB*>(x.b),
      static_cast<T*>(x.s), static_cast<T*>(x.c), x.m, x.n, x.k, x.block_k,
      scheme, split, vec_a, vec_b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `forced` (tm 0: none) replaces the plan of grid_plan; one that does not
// fit is refused
template <typename T, typename TA, typename TB>
int launch_grid(int scheme, const Args& x, GridPlan forced) {
  if (scheme < NAIVE || scheme > DOT2) return (int)cudaErrorInvalidValue;
  if (forced.tm != 0 && !plan_fits<T>(forced, x.batch, x.k / x.block_k))
    return (int)cudaErrorInvalidValue;
  const GridPlan plan = forced.tm != 0
                            ? forced
                            : grid_plan<T>(x.batch, x.m, x.n, x.k, x.block_k);
  if (plan.tm == 32) return launch_tile<T, TA, TB, 32>(scheme, plan.split, x);
  if (plan.tm == 64) return launch_tile<T, TA, TB, 64>(scheme, plan.split, x);
  if constexpr (sizeof(typename Compute<T>::type) == 8)
    return (int)cudaErrorInvalidValue;
  else
    return launch_tile<T, TA, TB, 128>(scheme, plan.split, x);
}

// The M <= 8 path: 32 columns per CTA where that still gives
// kRowWideCtas CTAs (N = 8192 at batch 1), else 16; groups = min(steps,
// 16, 256 / cols); tile_k the power of two in [8, 128] that brings a
// stage's B closest under kRowStageBytes.
template <typename T, typename TA, typename TB, int MR>
int launch_rows(int scheme, const Args& x) {
  const int lg_cols = (long long)((x.n + 31) / 32) * x.batch >= kRowWideCtas
                      ? 5 : 4;
  const int cols = 1 << lg_cols;
  const int steps = x.k / x.block_k;
  int groups = steps < kRowMaxGroups ? steps : kRowMaxGroups;
  if (groups * cols > kRowThreads) groups = kRowThreads / cols;
  int lg_tile_k = 3;
  while (lg_tile_k < 7 && (groups * cols * (int)sizeof(TB)
                           << (lg_tile_k + 1)) <= kRowStageBytes)
    ++lg_tile_k;
  const int tile_k = 1 << lg_tile_k;
  const auto aligned = [](const void* p, long long row_bytes) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_bytes % 16 == 0;
  };
  const int vec_a = aligned(x.a, (long long)x.k * sizeof(TA))
                    && ((long long)x.block_k * sizeof(TA)) % 16 == 0;
  const int vec_b = aligned(x.b, (long long)x.n * sizeof(TB));
  const size_t smem =
      (size_t)kRowStages * groups * tile_k
          * (cols * sizeof(TB) + x.m * sizeof(TA))
      + (size_t)groups * x.m * cols * sizeof(typename Compute<T>::type);
  const dim3 grid((x.n + cols - 1) / cols, x.batch);
  auto ta = static_cast<const TA*>(x.a);
  auto tb = static_cast<const TB*>(x.b);
  auto ts = static_cast<T*>(x.s);
  auto tc = static_cast<T*>(x.c);
  cudaError_t err = cudaSuccess;
#define REPRO_MATMUL_ROWS(S)                                                \
  {                                                                         \
    auto kern = kahan_matmul_rows<S, T, TA, TB, MR>;                        \
    static size_t smem_set = 48 * 1024;                                     \
    if (smem > smem_set) {                                                  \
      err = cudaFuncSetAttribute(                                           \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);    \
      if (err != cudaSuccess) return (int)err;                              \
      smem_set = smem;                                                      \
    }                                                                       \
    kern<<<grid, groups * cols, smem, x.stream>>>(                          \
        ta, tb, ts, tc, x.m, x.n, x.k, x.block_k, groups, lg_cols, tile_k,  \
        lg_tile_k, vec_a, vec_b);                                           \
  }
  switch (scheme) {
    case NAIVE: REPRO_MATMUL_ROWS(NAIVE); break;
    case KAHAN: REPRO_MATMUL_ROWS(KAHAN); break;
    case PAIRWISE: REPRO_MATMUL_ROWS(PAIRWISE); break;
    case DOT2: REPRO_MATMUL_ROWS(DOT2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MATMUL_ROWS
  return (int)cudaGetLastError();
}

template <typename T, typename TA, typename TB>
int launch_types(int scheme, const Args& x, GridPlan forced) {
  if (x.m > 8) return launch_grid<T, TA, TB>(scheme, x, forced);
  if (forced.tm != 0 || forced.split != 0) return (int)cudaErrorInvalidValue;
  if (x.m == 1) return launch_rows<T, TA, TB, 1>(scheme, x);
  if (x.m == 2) return launch_rows<T, TA, TB, 2>(scheme, x);
  if (x.m <= 4) return launch_rows<T, TA, TB, 4>(scheme, x);
  return launch_rows<T, TA, TB, 8>(scheme, x);
}

}  // namespace

// C entry point. dtype codes: 0 = float32, 1 = float64, 2 = bfloat16.
// dtype is the compute dtype of s, c and every operation; a_dtype and
// b_dtype are the operands' (float32 or bfloat16 for a float32 compute
// dtype, float64 for float64, bfloat16 for bfloat16). a [batch, m, k] and
// b [batch, k, n] are row-major contiguous, k a multiple of block_k. tm and
// split force the M > 8 path's plan (both 0: kahan_matmul_plan's); a plan
// that plan_fits refuses, or any at M <= 8, is refused. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int kahan_matmul_launch(int scheme, int dtype, int a_dtype,
                                   int b_dtype, const void* a, const void* b,
                                   void* s, void* c, int batch, int m, int n,
                                   int k, int block_k, int tm, int split,
                                   void* stream) {
  if (batch < 1 || batch > 65535 || m < 1 || n < 1 || k < 1 ||
      block_k < 1 || k % block_k != 0 || (tm == 0) != (split == 0))
    return (int)cudaErrorInvalidValue;
  const Args x{a, b, s, c, batch, m, n, k, block_k,
               static_cast<cudaStream_t>(stream)};
  const GridPlan forced{tm, split};
  if (dtype == 0) {
    if (a_dtype == 0 && b_dtype == 0) return launch_types<float, float, float>(scheme, x, forced);
    if (a_dtype == 0 && b_dtype == 2) return launch_types<float, float, __nv_bfloat16>(scheme, x, forced);
    if (a_dtype == 2 && b_dtype == 0) return launch_types<float, __nv_bfloat16, float>(scheme, x, forced);
    if (a_dtype == 2 && b_dtype == 2) return launch_types<float, __nv_bfloat16, __nv_bfloat16>(scheme, x, forced);
  } else if (dtype == 1 && a_dtype == 1 && b_dtype == 1) {
    return launch_types<double, double, double>(scheme, x, forced);
  } else if (dtype == 2 && a_dtype == 2 && b_dtype == 2) {
    return launch_types<Bf16, __nv_bfloat16, __nv_bfloat16>(scheme, x, forced);
  }
  return (int)cudaErrorInvalidValue;
}

// The plan the M > 8 path takes for a call (dtype 0 = float32, 1 =
// float64, 2 = bfloat16): rows a tile, columns a tile and the cluster
// size. M <= 8
// runs kahan_matmul_rows and has no such plan (all three are 0).
extern "C" int kahan_matmul_plan(int dtype, int batch, int m, int n, int k,
                                 int block_k, int* tm, int* tn, int* split) {
  *tm = *tn = *split = 0;
  if (batch < 1 || m < 1 || n < 1 || k < 1 || block_k < 1 ||
      k % block_k != 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (m <= 8) return 0;
  const GridPlan plan = dtype == 1   ? grid_plan<double>(batch, m, n, k, block_k)
                        : dtype == 2 ? grid_plan<Bf16>(batch, m, n, k, block_k)
                                     : grid_plan<float>(batch, m, n, k, block_k);
  *tm = plan.tm;
  *tn = kTileN;
  *split = plan.split;
  return 0;
}

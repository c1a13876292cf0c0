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
// code per operand), float64 when it is float64, and is widened to the
// compute dtype when it is staged into shared memory. Widening is exact,
// so the bits equal those of operands promoted first, and bf16 weights are
// read as they are stored, never copied. The caller pads N and K to its
// blocks with zeros and passes M as it is; the kernel masks the rows and
// columns of its own tile past M and N.
//
// Two paths, chosen by M; both give the bits above.
//
// M > 8 (chunks and prefill): one CTA of 256 threads owns a 64 x 64 tile
// of outputs; each thread owns 4 x 4 cells (rows ty + 16 * i, columns
// tx + 16 * j, so a warp reads consecutive columns) and keeps their p, s
// and c in registers. K is staged through shared memory kTileK columns at
// a time, inside each K-block. Bound on the H100: the 2 * M * N * K
// float32 operations over 67 TFLOP/s; the fixed in-block chain forbids
// tensor cores, separate multiply and add halve the CUDA cores' fma rate,
// and this tile overlaps no load with compute.
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
//   K-block: B as stored, widened where it is read), issued by every
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "schemes.cuh"

namespace {

using namespace repro_schemes;

constexpr int kThreads = 256;
constexpr int kTileK = 32;    // K columns staged per shared-memory step

template <typename T> __device__ __forceinline__ T widen(float x) { return T(x); }
template <typename T> __device__ __forceinline__ T widen(double x) { return T(x); }
template <typename T> __device__ __forceinline__ T widen(__nv_bfloat16 x) {
  return T(__bfloat162float(x));
}

template <int S, typename T, typename TA, typename TB, int TM, int TN, int RM,
          int RN>
__global__ void __launch_bounds__(kThreads)
kahan_matmul_grid(const TA* __restrict__ a, const TB* __restrict__ b,
                  T* __restrict__ s_out, T* __restrict__ c_out, int m, int n,
                  int k, int block_k) {
  constexpr int TX = TN / RN;
  constexpr int TY = TM / RM;
  static_assert(TX * TY == kThreads, "the thread grid must cover the tile");
  // +1: the A staging writes run along k, a column of this array
  __shared__ T a_sh[kTileK][TM + 1];
  __shared__ T b_sh[kTileK][TN];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const long long batch = blockIdx.z;
  a += batch * m * (long long)k;
  b += batch * k * (long long)n;
  s_out += batch * m * (long long)n;
  c_out += batch * m * (long long)n;

  T p[RM][RN], s[RM][RN], c[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) { s[i][j] = T(0); c[i][j] = T(0); }

  const int steps = k / block_k;
  for (int g = 0; g < steps; ++g) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) p[i][j] = T(0);
    const int k_end = (g + 1) * block_k;
    for (int k0 = g * block_k; k0 < k_end; k0 += kTileK) {
      const int kt = min(kTileK, k_end - k0);
      // stage A [TM rows x kt cols] (row-major: threads along k) and
      // B [kt rows x TN cols] (threads along n), widened, zero past M / N
      for (int e = threadIdx.x; e < TM * kTileK; e += kThreads) {
        const int r = e / kTileK, kk = e % kTileK;
        const int row = m0 + r;
        a_sh[kk][r] = (row < m && kk < kt)
                        ? widen<T>(a[(long long)row * k + k0 + kk]) : T(0);
      }
      for (int e = threadIdx.x; e < kTileK * TN; e += kThreads) {
        const int kk = e / TN, col = e % TN;
        b_sh[kk][col] = (n0 + col < n && kk < kt)
                          ? widen<T>(b[(long long)(k0 + kk) * n + n0 + col])
                          : T(0);
      }
      __syncthreads();
      for (int kk = 0; kk < kt; ++kk) {
        T av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = a_sh[kk][ty + TY * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = b_sh[kk][tx + TX * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) p[i][j] = p[i][j] + av[i] * bv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) update<S>(s[i][j], c[i][j], p[i][j], g);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty + TY * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + tx + TX * j;
      if (col >= n) continue;
      s_out[(long long)row * n + col] = s[i][j];
      c_out[(long long)row * n + col] = c[i][j];
    }
  }
}

// ---- M <= 8: K-blocks in parallel, folded in order (see the note above) --

constexpr int kRowThreads = 256;      // at most, = groups * cols
constexpr int kRowMaxGroups = 16;     // K-blocks formed at once per CTA
constexpr int kRowStages = 4;         // cp.async ring depth
constexpr int kRowStageBytes = 16384; // B bytes a stage aims at
constexpr int kRowWideCtas = 256;     // 32 columns per CTA from this many

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

template <int S, typename T, typename TA, typename TB, int MR>
__global__ void __launch_bounds__(kRowThreads)
kahan_matmul_rows(const TA* __restrict__ a, const TB* __restrict__ b,
                  T* __restrict__ s_out, T* __restrict__ c_out, int m, int n,
                  int k, int block_k, int groups, int lg_cols, int tile_k,
                  int lg_tile_k, int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = 1 << lg_cols;
  TB* b_sh = reinterpret_cast<TB*>(smem);
  TA* a_sh = reinterpret_cast<TA*>(
      smem + ((size_t)kRowStages * groups * tile_k * sizeof(TB) << lg_cols));
  T* p_sh = reinterpret_cast<T*>(
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

  T p[MR], s[MR], c[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) { p[i] = T(0); s[i] = T(0); c[i] = T(0); }

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
        const T bv = widen<T>(bs[kk << lg_cols]);
#pragma unroll
        for (int i = 0; i < MR; ++i)
          if (i < m) p[i] = p[i] + widen<T>(as[i * tile_k + kk]) * bv;
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
      for (int i = 0; i < MR; ++i) p[i] = T(0);
    }
  }
  cp_async_wait<0>();

  if (j == 0 && live_col) {
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      if (i >= m) continue;
      s_out[(long long)i * n + n0 + col] = s[i];
      c_out[(long long)i * n + n0 + col] = c[i];
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

template <typename T, typename TA, typename TB, int TM, int TN, int RM, int RN>
int launch_tile(int scheme, const Args& x) {
  const dim3 grid((x.n + TN - 1) / TN, (x.m + TM - 1) / TM, x.batch);
  auto ta = static_cast<const TA*>(x.a);
  auto tb = static_cast<const TB*>(x.b);
  auto ts = static_cast<T*>(x.s);
  auto tc = static_cast<T*>(x.c);
#define REPRO_MATMUL_LAUNCH(S)                                              \
  kahan_matmul_grid<S, T, TA, TB, TM, TN, RM, RN>                           \
      <<<grid, kThreads, 0, x.stream>>>(ta, tb, ts, tc, x.m, x.n, x.k,      \
                                        x.block_k)
  switch (scheme) {
    case NAIVE: REPRO_MATMUL_LAUNCH(NAIVE); break;
    case KAHAN: REPRO_MATMUL_LAUNCH(KAHAN); break;
    case PAIRWISE: REPRO_MATMUL_LAUNCH(PAIRWISE); break;
    case DOT2: REPRO_MATMUL_LAUNCH(DOT2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MATMUL_LAUNCH
  return (int)cudaGetLastError();
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
      + (size_t)groups * x.m * cols * sizeof(T);
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
int launch_types(int scheme, const Args& x) {
  if (x.m == 1) return launch_rows<T, TA, TB, 1>(scheme, x);
  if (x.m == 2) return launch_rows<T, TA, TB, 2>(scheme, x);
  if (x.m <= 4) return launch_rows<T, TA, TB, 4>(scheme, x);
  if (x.m <= 8) return launch_rows<T, TA, TB, 8>(scheme, x);
  return launch_tile<T, TA, TB, 64, 64, 4, 4>(scheme, x);
}

}  // namespace

// C entry point. dtype codes: 0 = float32, 1 = float64, 2 = bfloat16.
// dtype is the compute dtype of s, c and every operation; a_dtype and
// b_dtype are the operands' (float32 or bfloat16 for a float32 compute
// dtype, float64 for float64). a [batch, m, k] and b [batch, k, n] are
// row-major contiguous, k a multiple of block_k. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int kahan_matmul_launch(int scheme, int dtype, int a_dtype,
                                   int b_dtype, const void* a, const void* b,
                                   void* s, void* c, int batch, int m, int n,
                                   int k, int block_k, void* stream) {
  if (batch < 1 || batch > 65535 || m < 1 || n < 1 || k < 1 ||
      block_k < 1 || k % block_k != 0)
    return (int)cudaErrorInvalidValue;
  const Args x{a, b, s, c, batch, m, n, k, block_k,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    if (a_dtype == 0 && b_dtype == 0) return launch_types<float, float, float>(scheme, x);
    if (a_dtype == 0 && b_dtype == 2) return launch_types<float, float, __nv_bfloat16>(scheme, x);
    if (a_dtype == 2 && b_dtype == 0) return launch_types<float, __nv_bfloat16, float>(scheme, x);
    if (a_dtype == 2 && b_dtype == 2) return launch_types<float, __nv_bfloat16, __nv_bfloat16>(scheme, x);
  } else if (dtype == 1 && a_dtype == 1 && b_dtype == 1) {
    return launch_types<double, double, double>(scheme, x);
  }
  return (int)cudaErrorInvalidValue;
}

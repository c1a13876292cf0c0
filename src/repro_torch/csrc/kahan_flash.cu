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
// as torch.exp on the card. float32 only (the default compute dtype);
// the wrappers raise TypeError for other dtypes on the card.
//
// Layout: one CTA = kRows query rows of one head-row (grid: ceil(Sq /
// kRows) x BH); the q tile stays in shared memory. Per k-block, K then V
// stream through one shared sub-tile of kKeys keys (row stride dh + 4, or
// dh + 1 when dh is not a multiple of 4: the score loop reads one key per
// lane without bank conflicts); the kRows x block_k score/probability
// block and its rowsum tree stay in shared memory; m, l_s, l_c per row in
// shared memory, and each thread keeps its acc_s, acc_c and pv outputs in
// registers.
//
// What bounds it on the H100: fp32 CUDA-core operations, 4 * BH * Sq_pad
// * Skv_pad * dh FLOPs (both contractions, masked blocks included) at
// 67 TFLOP/s; q, k, v and the four outputs cross HBM once each, far less
// time at 3.35 TB/s. Fixed-order chains forbid tensor cores and split-k,
// so the design keeps each product's operands in shared memory and cuts
// shared-memory reads per multiply-add: the score loop reads q and k as
// float4 along dh and reuses each key across 4 score rows of a thread;
// the PV loop, when dh divides the block (every thread's outputs in one
// column), reads each V value once for all its rows and p as float4 along
// the keys. Every index is computed outside the inner loops (dh is a
// runtime value, and an integer division costs tens of instructions).
// The chains keep their order: float4 reads only batch the loads of 4
// consecutive terms. Deeper register blocking and overlapping the tile
// loads with compute (cp.async / TMA) are later work.

#include <cuda_runtime.h>

#include "schemes.cuh"

namespace {

using namespace repro_schemes;

constexpr int kThreads = 256;
constexpr int kRows = 16;                       // query rows per CTA
constexpr int kKeys = 64;                       // keys per K/V sub-tile
constexpr int kRowGroups = kThreads / kKeys;    // score rows per thread step
constexpr int kMaxDh = 256;
constexpr int kMaxOut = kRows * kMaxDh / kThreads;
constexpr float kNegInf = -1e30f;               // NEG_INF of the reference
static_assert(kRows % kRowGroups == 0, "score rows must tile kRows");

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// row stride of the K/V sub-tile: dh + 4 keeps rows 16-byte aligned for
// float4 reads (and conflict-free: row j starts 16 * j bytes into a bank
// line); dh + 1 otherwise
__host__ __device__ inline int tile_ld(int dh) {
  return dh % 4 == 0 ? dh + 4 : dh + 1;
}

// floats of dynamic shared memory for (dh, block_k); every region starts
// 16-byte aligned
__host__ __device__ inline long long smem_floats(int dh, int bk) {
  const int half = pow2_at_least(bk) / 2;
  return (long long)round4(kRows * dh) + round4(kRows * bk) +
         round4(kRows * (half > 0 ? half : 1)) +
         round4(kKeys * tile_ld(dh)) + 4LL * kRows;
}

// one K or V sub-tile [nk, dh] -> shared [nk][ld]. Element e =
// tid + n * kThreads sits at (j, d) = divmod(e, dh); the walk steps (j, d)
// with a carry instead of dividing per element (dh is a runtime value,
// and an integer division costs tens of instructions).
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int nk, int dh, int ld, int j0,
                                          int d0) {
  const int sj = kThreads / dh, sd = kThreads - (kThreads / dh) * dh;
  for (int j = j0, d = d0; j < nk;) {
    tile[j * ld + d] = src[j * dh + d];
    j += sj;
    d += sd;
    if (d >= dh) { d -= dh; ++j; }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
kahan_flash_grid(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ ls_out,
                 float* __restrict__ lc_out, float* __restrict__ as_out,
                 float* __restrict__ ac_out, int q_groups, int sq, int skv,
                 int dh, int bk, int kv_len, int q_off, int causal,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int rows = min(kRows, sq - q0);
  const int half = pow2_at_least(bk) / 2;

  const int ld = tile_ld(dh);
  const bool vec_d = dh % 4 == 0;              // float4 reads along dh
  const bool vec_j = bk % 4 == 0;              // float4 reads along keys
  float* qs = smem;                              // [kRows][dh]
  float* sc = qs + round4(kRows * dh);           // [kRows][bk]
  float* tr = sc + round4(kRows * bk);           // [kRows][max(half, 1)]
  float* kv = tr + round4(kRows * (half > 0 ? half : 1));  // [kKeys][ld]
  float* row_m = kv + round4(kKeys * ld);
  float* row_corr = row_m + kRows;
  float* row_ls = row_corr + kRows;
  float* row_lc = row_ls + kRows;

  const long long qrow0 = (long long)bh * sq + q0;
  const long long kvbase = (long long)(bh / q_groups) * skv * dh;

  for (int e = tid; e < kRows * dh; e += kThreads)
    qs[e] = e / dh < rows ? q[qrow0 * dh + e] : 0.0f;
  if (tid < kRows) {
    row_m[tid] = kNegInf;
    row_ls[tid] = 0.0f;
    row_lc[tid] = 0.0f;
  }
  // this thread's outputs: elements e = tid + r * kThreads of the
  // [kRows, dh] acc block, r < n_out, at row o_row[r] and column o_col[r]
  const int n_out = tid < kRows * dh
                        ? (kRows * dh - tid + kThreads - 1) / kThreads : 0;
  int o_row[kMaxOut], o_col[kMaxOut];
  float a_s[kMaxOut], a_c[kMaxOut], pv[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    o_row[r] = (tid + r * kThreads) / dh;
    o_col[r] = tid + r * kThreads - o_row[r] * dh;
    a_s[r] = 0.0f;
    a_c[r] = 0.0f;
  }
  const int t_j = tid / dh, t_d = tid - (tid / dh) * dh;   // load_tile start
  // when dh divides kThreads every output of this thread sits in one
  // column, so the PV loop reads each V value once for all its rows
  const bool one_col = kThreads % dh == 0;
  __syncthreads();

  const int n_kb = skv / bk;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int key0 = kb * bk;

    // 1. scores s[i][j] = sum_d q[i][d] * k[j][d], ascending d
    for (int kt = 0; kt < bk; kt += kKeys) {
      const int nk = min(kKeys, bk - kt);
      load_tile(kv, k + kvbase + (long long)(key0 + kt) * dh, nk, dh, ld,
                t_j, t_d);
      __syncthreads();
      // this thread: key j of the sub-tile, rows i0 + r * kRowGroups
      const int j = tid % kKeys;
      const int i0 = tid / kKeys;
      if (j < nk) {
        const float* kj = kv + j * ld;
        float s[kRows / kRowGroups];
#pragma unroll
        for (int r = 0; r < kRows / kRowGroups; ++r) s[r] = 0.0f;
        if (vec_d) {
          for (int d = 0; d < dh; d += 4) {
            const float4 kd = *reinterpret_cast<const float4*>(kj + d);
#pragma unroll
            for (int r = 0; r < kRows / kRowGroups; ++r) {
              const float4 qd = *reinterpret_cast<const float4*>(
                  qs + (i0 + r * kRowGroups) * dh + d);
              s[r] = s[r] + qd.x * kd.x;
              s[r] = s[r] + qd.y * kd.y;
              s[r] = s[r] + qd.z * kd.z;
              s[r] = s[r] + qd.w * kd.w;
            }
          }
        } else {
          for (int d = 0; d < dh; ++d) {
            const float kd = kj[d];
#pragma unroll
            for (int r = 0; r < kRows / kRowGroups; ++r)
              s[r] = s[r] + qs[(i0 + r * kRowGroups) * dh + d] * kd;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows / kRowGroups; ++r)
          sc[(i0 + r * kRowGroups) * bk + kt + j] = s[r];
      }
      __syncthreads();
    }

    // 2. per row (one warp each): scale, mask, max, exp, rowsum tree, and
    //    the l fold
    for (int i = warp; i < kRows; i += kThreads / 32) {
      float* si = sc + i * bk;
      const long long qpos = (long long)q_off + q0 + i;
      // (m_old >= NEG_INF, so starting the row maximum there gives the
      // reference's max(m_old, rowmax(s)))
      float mx = kNegInf;
      for (int j = lane; j < bk; j += 32) {
        const int kpos = key0 + j;
        float s = si[j] * scale;
        bool valid = kpos < kv_len;
        if (causal) valid = valid && qpos >= kpos;
        s = valid ? s : kNegInf;
        si[j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row_m[i];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      for (int j = lane; j < bk; j += 32) si[j] = expf(si[j] - m_new);
      __syncwarp();
      float p_sum;
      if (half == 0) {
        p_sum = si[0];
      } else {
        // rowsum_tree: zero-pad to a power of two, add halves
        float* ti = tr + i * half;
        for (int j = lane; j < half; j += 32)
          ti[j] = si[j] + (j + half < bk ? si[j + half] : 0.0f);
        __syncwarp();
        for (int h = half / 2; h >= 1; h /= 2) {
          for (int j = lane; j < h; j += 32) ti[j] = ti[j] + ti[j + h];
          __syncwarp();
        }
        p_sum = ti[0];
      }
      if (lane == 0) {
        float ls = row_ls[i] * corr;
        float lc = row_lc[i] * corr;
        update<S>(ls, lc, p_sum, kb);
        row_ls[i] = ls;
        row_lc[i] = lc;
        row_m[i] = m_new;
        row_corr[i] = corr;
      }
    }
    __syncthreads();

    // 3. pv[i][d] = sum_j p[i][j] * v[j][d], ascending j, then the acc fold
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) pv[r] = 0.0f;
    for (int kt = 0; kt < bk; kt += kKeys) {
      const int nk = min(kKeys, bk - kt);
      load_tile(kv, v + kvbase + (long long)(key0 + kt) * dh, nk, dh, ld,
                t_j, t_d);
      __syncthreads();
      int j = 0;
      if (one_col && vec_j) {
        const int col = o_col[0];
        for (; j + 4 <= nk; j += 4) {
          const float v0 = kv[j * ld + col], v1 = kv[(j + 1) * ld + col];
          const float v2 = kv[(j + 2) * ld + col];
          const float v3 = kv[(j + 3) * ld + col];
#pragma unroll
          for (int r = 0; r < kMaxOut; ++r) {
            if (r < n_out) {
              const float4 p4 = *reinterpret_cast<const float4*>(
                  sc + o_row[r] * bk + kt + j);
              pv[r] = pv[r] + p4.x * v0;
              pv[r] = pv[r] + p4.y * v1;
              pv[r] = pv[r] + p4.z * v2;
              pv[r] = pv[r] + p4.w * v3;
            }
          }
        }
      }
      for (; j < nk; ++j) {
        const float* vj = kv + j * ld;
        const float* pj = sc + kt + j;
#pragma unroll
        for (int r = 0; r < kMaxOut; ++r)
          if (r < n_out) pv[r] = pv[r] + pj[o_row[r] * bk] * vj[o_col[r]];
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      if (r < n_out) {
        const float corr = row_corr[o_row[r]];
        float as = a_s[r] * corr;
        float ac = a_c[r] * corr;
        update<S>(as, ac, pv[r], kb);
        a_s[r] = as;
        a_c[r] = ac;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    if (r < n_out && o_row[r] < rows) {
      as_out[qrow0 * dh + tid + r * kThreads] = a_s[r];
      ac_out[qrow0 * dh + tid + r * kThreads] = a_c[r];
    }
  }
  if (tid < rows) {
    ls_out[qrow0 + tid] = row_ls[tid];
    lc_out[qrow0 + tid] = row_lc[tid];
  }
}

template <int S>
int launch(const float* q, const float* k, const float* v, float* ls,
           float* lc, float* as, float* ac, int bh, int q_groups, int sq,
           int skv, int dh, int bk, int kv_len, int q_off, int causal,
           float scale, size_t smem, cudaStream_t st) {
  // opt in to more than 48 KB of dynamic shared memory, once per scheme
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kahan_flash_grid<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  kahan_flash_grid<S><<<grid, kThreads, smem, st>>>(
      q, k, v, ls, lc, as, ac, q_groups, sq, skv, dh, bk, kv_len, q_off,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. dtype: 0 = float32 (the only instantiation). q: [bh, sq,
// dh]; k, v: [bh / q_groups, skv, dh]; l_s, l_c: [bh, sq]; a_s, a_c: [bh,
// sq, dh]; all contiguous, skv a multiple of block_k. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int kahan_flash_launch(int scheme, int dtype, const void* q,
                                  const void* k, const void* v, void* l_s,
                                  void* l_c, void* a_s, void* a_c, int bh,
                                  int q_groups, int sq, int skv, int dh,
                                  int block_k, int kv_len, int q_off,
                                  int causal, float scale, void* stream) {
  if (dtype != 0 || dh < 1 || dh > kMaxDh || block_k < 1 || skv < block_k ||
      skv % block_k != 0 || q_groups < 1 || bh < 1 || bh % q_groups != 0 ||
      bh > 65535 || sq < 1)
    return (int)cudaErrorInvalidValue;
  const long long bytes = smem_floats(dh, block_k) * (long long)sizeof(float);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bytes;
  auto st = static_cast<cudaStream_t>(stream);
  auto tq = static_cast<const float*>(q);
  auto tk = static_cast<const float*>(k);
  auto tv = static_cast<const float*>(v);
  auto ls = static_cast<float*>(l_s);
  auto lc = static_cast<float*>(l_c);
  auto as = static_cast<float*>(a_s);
  auto ac = static_cast<float*>(a_c);
#define REPRO_FLASH_ARGS tq, tk, tv, ls, lc, as, ac, bh, q_groups, sq, skv, \
    dh, block_k, kv_len, q_off, causal, scale, smem, st
  switch (scheme) {
    case NAIVE: return launch<NAIVE>(REPRO_FLASH_ARGS);
    case KAHAN: return launch<KAHAN>(REPRO_FLASH_ARGS);
    case PAIRWISE: return launch<PAIRWISE>(REPRO_FLASH_ARGS);
    case DOT2: return launch<DOT2>(REPRO_FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_ARGS
}

// Compensated dot and sum on Hopper: the paper's two kernel bodies.
//
// Replaces the four Pallas calls of the JAX package:
//   kahan_dot_grid  <- repro/kernels/kahan_dot.py  dot_accumulators (:89)
//                      and dot_accumulators_batched (:139), body _dot_kernel
//   kahan_sum_grid  <- repro/kernels/kahan_sum.py  sum_accumulators (:63)
//                      and sum_accumulators_batched (:105), body _sum_kernel
//
// Layout (the reference's, so the (s, c) grids are bitwise equal): the
// input row of length n (padded by the caller to a multiple of cells = 8 *
// U * 128) is read as steps = n / cells blocks of [8U, 128]; accumulator
// cell (r, l) folds element g * cells + r * 128 + l at step g, in order g
// = 0 .. steps-1. Each cell of each batch row is one thread's chain: the
// thread keeps its (s, c) pair in registers, folds its elements in
// ascending g through mul_update / update of schemes.cuh and writes its
// cell of the [B, 8U, 128] s and c grids at the end. Only that per-cell
// order fixes the bits; which CTA owns which cells, and how the data reach
// shared memory, change none. One launch serves the single and the batched
// call: blockIdx.y is the batch row. No atomics, no cross-block reduction:
// the two-sum merge of the grid stays in torch (kernels/engine.py), as it
// stays outside Pallas in the reference.
//
// Arithmetic: built with -fmad=false, so no product is contracted by the
// compiler. __fmaf_rn / __fma_rn sit at exactly the two sites where XLA
// on the CPU contracts the reference: s = fma(a, b, s) in naive and
// pairwise, y = fma(a, b, c) in kahan. dot2's TwoProd uses the Veltkamp
// split with plain ops; the sum kernel has no fma. The scheme is a
// template argument (ids in kernels/schemes.py). T is float, double or
// Bf16: the reference rounds every bfloat16 op separately and contracts
// nothing, which Bf16 reproduces with the conversion intrinsics (each op
// computed in float32, rounded to bfloat16). The schemes' update and
// mul_update live in schemes.cuh, shared with kahan_flash.cu.
//
// What bounds it on the H100: bytes. Every input byte is read once, so
// the bound is n * sizeof(T) per operand over 3.35 TB/s: 0.3205 ms for
// the dot and 0.1603 ms for the sum at n = 2^27 float32. Below that sits
// the chain floor. Bitwise parity fixes the chains at 1024 * U (8192 at
// U = 8), each serial: kahan's loop-carried path is 4 dependent float32
// ops (c -> y -> t -> t - s -> c), about 16 cycles a step, so the 16384
// steps of a chain at n = 2^27 take about 262k cycles, 0.13-0.15 ms at
// 1.98-1.755 GHz. That is well under the dot's bytes bound and just under
// the sum's; naive's path is one op.
//
// What the kernel does about it (the earlier kernel, one thread a cell in
// 128-thread CTAs with 8 steps of loads drained before each chain burst,
// ran 64 CTAs on 132 SMs with at most 8 KB in flight an SM: 22-24% of the
// bound):
// 1. Fill the card. A CTA owns `chains` consecutive cells of one batch
//    row (32, 64 or 128: one consumer thread each) plus four producer
//    warps. The host plan (kernels/kahan_dot.py::reduce_plan) takes the
//    widest CTA whose grid puts the fewest chains on the busiest SM: 64
//    at U = 8 for one row (128 CTAs on 132 SMs; no SM can hold fewer than
//    63 of 8192 chains, so 64 is the floor at warp granularity), 32 at
//    U = 1, 128 for the batched shapes (512+ CTAs).
// 2. Keep HBM busy: a ring in dynamic shared memory of `stages` stages of
//    `depth` steps (a multiple of 8, at most 64) of the CTA's lanes of
//    each operand, [stage][operand][step][chain]. The producer warps
//    refill a stage as soon as the consumers release it. Each stage has a
//    "full" and an "empty" mbarrier. A consumer reads its lane of 8 steps
//    at a time into registers (consecutive lanes, consecutive banks),
//    loading the next 8 between the two halves of the current 8's fold so
//    the shared-memory latency hides behind the chain; a stage's batches
//    but its last run with no barrier work, and at the last one the
//    consumer arrives on the stage's empty barrier and probes the next
//    stage's full barrier (test_wait) before the fold, waiting only if it
//    had not completed. The tail stage is partial when steps % depth !=
//    0; when steps < depth the ring is one partial stage (the serving
//    telemetry: 7 steps). Nothing is read past the row.
// 3. The copy engine: 16-byte cp.async (.cg), each producer thread's
//    copies tracked by the stage's full barrier through
//    cp.async.mbarrier.arrive.noinc (the barrier counts the 128 producer
//    threads). A warp pass copies whole 16-byte pieces of one or more
//    segments (a segment: one step of one operand, chains * sizeof(T)
//    contiguous bytes at g * cells + cell0), and each thread keeps its
//    piece's offsets, so a copy costs a few integer adds. Why not the
//    bulk copy (cp.async.bulk with complete_tx), which moves a segment in
//    one instruction: on an H100 it kept B1 far from the bytes bound
//    whatever the ring's depth, since a segment is at most chains *
//    sizeof(T) bytes and the copy engine's cost is per request. A 2-D
//    tensor map (box [depth, chains]) would make a request a stage, but
//    needs the driver API (cuTensorMapEncodeTiled through
//    cudaGetDriverEntryPoint: the library links no -lcuda) and a map per
//    launch. With cp.async, what one producer warp keeps in flight held a
//    CTA at a fixed rate whatever the ring's depth, so the CTA has four
//    producer warps and stages of up to 16 KB (scripts/reduce_rings.py
//    times the plans).
// 4. Operands off 16 bytes (a contiguous view at an odd offset, which the
//    engine passes on when it need not pad): the same ring, one element a
//    copy (cp.async of 4 or 8 bytes; bfloat16 by plain loads and stores,
//    each producer thread arriving on the full barrier after its stores).
//    The wrapper picks the path from the pointers (`copy`); the C entry
//    refuses 16-byte copies from a misaligned pointer. No operand is
//    copied, and nothing falls back to the plain version.
//
// Plan budgets (checked by the C entry against the host's plan): shared
// bytes = stages * (operands * depth * chains * sizeof(T) + 16), at most
// 232448; chains divides cells. The plan gives the rings of an SM's
// resident CTAs 64 KB, in stages of at most 16 KB and half a CTA's ring,
// at least two. At n = 2^27 float32: dot 64 chains, 4 stages of 32 steps
// (65600 bytes); sum 64 chains, 4 stages of 64 (65600); at [8, 2^24]: 128
// chains, 2 stages of 8 (dot) or 16 (sum) steps (16416 bytes).

#include <cstdint>

#include <cuda_runtime.h>

#include "schemes.cuh"

namespace {

using namespace repro_schemes;

constexpr int kMaxChains = 128;   // consumer threads a CTA, at most
constexpr int kMaxDepth = 64;     // steps a stage, at most
constexpr int kProducer = 128;    // the producer warps' threads
constexpr int kBatch = 8;         // steps a consumer holds in registers
constexpr long long kSmemLimit = 232448;

struct Ring {
  long long n;    // row length, a multiple of cells
  int cells;      // 1024 * U
  int chains;     // cells (consumer threads) a CTA
  int depth;      // steps a stage
  int stages;
  int copy;       // kElement or kAsync16
};

// How the producer fills the ring: 16-byte cp.async (every operand
// 16-byte aligned), or one element a copy (operands off 16 bytes).
constexpr int kElement = 0, kAsync16 = 1;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Whether the phase of parity `parity` has completed (does not block).
__device__ __forceinline__ bool bar_test(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// One copy of G bytes into the ring: cp.async of 16 bytes (.cg, past L1)
// or of one 4- or 8-byte element (.ca); a bfloat16 element by a plain
// load and store.
template <int G, typename T>
__device__ __forceinline__ void copy_piece(T* dst, const T* src) {
  if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  } else if constexpr (G >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(G) : "memory");
  } else {
    *dst = *src;
  }
}

// The barrier's pending count drops by one once every cp.async this
// thread issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// The producers' part of one stage: steps g0 .. g0 + cnt - 1 of each
// operand, G bytes a copy. A segment (one step of one operand) is
// `parts` copies; `width` producer threads cover one, so a pass of the
// kProducer threads copies `spw` segments and each thread keeps its piece
// offset: a copy costs a few integer adds.
template <int G, int OPS, typename T>
__device__ __forceinline__ void fill(T* stage, const T* row_a,
                                     const T* row_b, long long g0, int cnt,
                                     const Ring& r, int lane) {
  constexpr int per = G / sizeof(T);      // elements a copy
  const int parts = r.chains / per;
  const int width = parts < kProducer ? parts : kProducer;
  const int spw = kProducer / width;
  const int sub = lane / width;
  const int e = (lane - sub * width) * per;
#pragma unroll
  for (int op = 0; op < OPS; ++op) {
    const T* src = (op ? row_b : row_a) + (g0 + sub) * r.cells + e;
    T* dst = stage + (op * r.depth + sub) * r.chains + e;
#pragma unroll 4
    for (int k = sub; k < cnt; k += spw) {
      for (int p = 0; p < parts; p += width)
        copy_piece<G>(dst + p * per, src + p * per);
      src += spw * r.cells;
      dst += spw * r.chains;
    }
  }
}

// Fold steps J0 .. J1-1 of a batch of kBatch (those below `lim`) of one
// chain, in order.
template <int S, int OPS, int J0, int J1, bool kFull, typename T>
__device__ __forceinline__ void fold(T& s, T& c, const T (&xa)[kBatch],
                                     const T (&xb)[kBatch], long long g,
                                     int lim) {
  // g is a non-negative multiple of kBatch: masking keeps its value and
  // tells the compiler so, which folds pairwise's g % 32 test to one
  // compare a batch
  g &= 0x7FFFFFFFFFFFFFFFLL & ~(long long)(kBatch - 1);
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    if (kFull || j < lim) {
      if constexpr (OPS == 2) {
        mul_update<S>(s, c, xa[j], xb[j], g + j);
      } else {
        update<S>(s, c, xa[j], g + j);
      }
    }
  }
}

// This lane's kBatch steps of each operand from a stage, from step slot p
// on (operand 1 sits depth * chains after operand 0).
template <int OPS, typename T>
__device__ __forceinline__ void take(T (&xa)[kBatch], T (&xb)[kBatch],
                                     const T* p, const Ring& r) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    xa[j] = p[j * r.chains];
    if constexpr (OPS == 2) xb[j] = p[(r.depth + j) * r.chains];
  }
}

// The body of both kernels: OPS = 2 (dot: a, b) or 1 (sum: a).
template <int S, int OPS, typename T>
__device__ __forceinline__ void ring_reduce(const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            T* __restrict__ s_out,
                                            T* __restrict__ c_out,
                                            const Ring& r) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int stage_elems = OPS * r.depth * r.chains;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)r.stages * stage_elems * sizeof(T));
  uint64_t* empty = full + r.stages;
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  const long long cell0 = (long long)blockIdx.x * r.chains;
  const long long steps = r.n / r.cells;

  if (tid == 0) {
    for (int i = 0; i < r.stages; ++i) {
      bar_init(&full[i], kProducer);
      bar_init(&empty[i], r.chains);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage st holds the rounds st, st + stages, ...; phase is the parity
  // of the current pass over the ring.
  int st = 0;
  unsigned phase = 0;
  if (tid >= r.chains) {
    // the producer warps: refill a stage once the consumers released its
    // previous round (the first pass finds every stage empty); each
    // producer thread arrives on the stage's full barrier once its copies
    // have landed
    const int lane = tid - r.chains;
    const T* row_a = a + row * r.n + cell0;
    const T* row_b = b + row * r.n + cell0;
    for (long long g0 = 0; g0 < steps; g0 += r.depth) {
      bar_wait(&empty[st], phase ^ 1u);
      const int cnt = (int)(steps - g0 < r.depth ? steps - g0 : r.depth);
      T* dst = ring + (size_t)st * stage_elems;
      if (r.copy == kAsync16) {
        fill<16, OPS>(dst, row_a, row_b, g0, cnt, r, lane);
        cp_async_arrive(&full[st]);
      } else if constexpr (sizeof(T) >= 4) {
        fill<sizeof(T), OPS>(dst, row_a, row_b, g0, cnt, r, lane);
        cp_async_arrive(&full[st]);
      } else {
        fill<sizeof(T), OPS>(dst, row_a, row_b, g0, cnt, r, lane);
        bar_arrive(&full[st]);
      }
      if (++st == r.stages) {
        st = 0;
        phase ^= 1u;
      }
    }
    return;
  }

  // a consumer: the chain of cell cell0 + tid. Each batch folds its first
  // half, then loads the next batch, then folds its second half, so the
  // shared-memory latency hides behind the chain. A stage's batches but
  // its last run in a loop with no barrier work; at its last batch (the
  // partial one when cnt % kBatch != 0) the stage is released, the next
  // stage's barrier is probed before the first half and waited on only if
  // it had not completed, and the next batch is that stage's first.
  const T* lane_slot = ring + tid;
  const int batch_stride = kBatch * r.chains;
  T s = T(0), c = T(0);
  T xa[kBatch], xb[kBatch];
  bar_wait(&full[0], 0);
  take<OPS>(xa, xb, lane_slot, r);
  for (long long g0 = 0; g0 < steps; g0 += r.depth) {
    const int cnt = (int)(steps - g0 < r.depth ? steps - g0 : r.depth);
    const bool more = g0 + r.depth < steps;
    const int st1 = st + 1 == r.stages ? 0 : st + 1;
    const unsigned phase1 = st1 == 0 ? phase ^ 1u : phase;
    const T* p = lane_slot + (size_t)st * stage_elems;
    const int inner = (cnt - 1) / kBatch;
    long long g = g0;
#pragma unroll 2
    for (int i = 0; i < inner; ++i) {
      p += batch_stride;
      T na[kBatch], nb[kBatch];
      fold<S, OPS, 0, kBatch / 2, true>(s, c, xa, xb, g, kBatch);
      take<OPS>(na, nb, p, r);
      fold<S, OPS, kBatch / 2, kBatch, true>(s, c, xa, xb, g, kBatch);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        xa[j] = na[j];
        if constexpr (OPS == 2) xb[j] = nb[j];
      }
      g += kBatch;
    }
    const int lim = cnt - inner * kBatch;
    bar_arrive(&empty[st]);
    const bool ready = !more || bar_test(&full[st1], phase1);
    if (lim == kBatch) {
      fold<S, OPS, 0, kBatch / 2, true>(s, c, xa, xb, g, lim);
    } else {
      fold<S, OPS, 0, kBatch / 2, false>(s, c, xa, xb, g, lim);
    }
    if (!ready) bar_wait(&full[st1], phase1);
    // past the last round: a harmless read of a landed stage
    T na[kBatch], nb[kBatch];
    take<OPS>(na, nb, more ? lane_slot + (size_t)st1 * stage_elems
                           : lane_slot, r);
    if (lim == kBatch) {
      fold<S, OPS, kBatch / 2, kBatch, true>(s, c, xa, xb, g, lim);
    } else {
      fold<S, OPS, kBatch / 2, kBatch, false>(s, c, xa, xb, g, lim);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      xa[j] = na[j];
      if constexpr (OPS == 2) xb[j] = nb[j];
    }
    st = st1;
    phase = phase1;
  }
  s_out[row * r.cells + cell0 + tid] = s;
  c_out[row * r.cells + cell0 + tid] = c;
}

template <int S, typename T>
__global__ void __launch_bounds__(kMaxChains + kProducer)
kahan_dot_grid(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ s_out, T* __restrict__ c_out, Ring r) {
  ring_reduce<S, 2, T>(a, b, s_out, c_out, r);
}

template <int S, typename T>
__global__ void __launch_bounds__(kMaxChains + kProducer)
kahan_sum_grid(const T* __restrict__ x, T* __restrict__ s_out,
               T* __restrict__ c_out, Ring r) {
  ring_reduce<S, 1, T>(x, x, s_out, c_out, r);
}

long long smem_bytes(const Ring& r, int operands, int itemsize) {
  return (long long)r.stages *
         ((long long)operands * r.depth * r.chains * itemsize + 16);
}

// The plan is one of the kernel's and its bytes match the layout; 16-byte
// copies have 16-byte-aligned operands.
bool plan_ok(const Ring& r, long long batch, long long smem, int operands,
             int itemsize, const void* a, const void* b) {
  if (batch < 1 || batch > 65535 || r.cells < 1 || r.n < r.cells ||
      r.n % r.cells != 0)
    return false;
  if ((r.chains != 32 && r.chains != 64 && r.chains != kMaxChains) ||
      r.cells % r.chains != 0 || r.depth < kBatch || r.depth > kMaxDepth ||
      r.depth % kBatch != 0 || r.stages < 1 ||
      smem != smem_bytes(r, operands, itemsize) || smem > kSmemLimit)
    return false;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
  };
  if (r.copy != kElement && r.copy != kAsync16) return false;
  return r.copy == kElement || !(misaligned(a) || misaligned(b));
}

// Launch one instantiation, opting it in to more than 48 KB of dynamic
// shared memory at its first launch that needs it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool& opted_in, const Ring& r, long long batch,
           long long smem, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid(r.cells / r.chains, (unsigned)batch);
  kernel<<<grid, r.chains + kProducer, (size_t)smem, st>>>(args..., r);
  return (int)cudaGetLastError();
}

template <int S, typename T>
int dot_one(const void* a, const void* b, void* s, void* c, const Ring& r,
            long long batch, long long smem, cudaStream_t st) {
  static bool opted_in = false;
  return launch(kahan_dot_grid<S, T>, opted_in, r, batch, smem, st,
                static_cast<const T*>(a), static_cast<const T*>(b),
                static_cast<T*>(s), static_cast<T*>(c));
}

template <int S, typename T>
int sum_one(const void* x, void* s, void* c, const Ring& r, long long batch,
            long long smem, cudaStream_t st) {
  static bool opted_in = false;
  return launch(kahan_sum_grid<S, T>, opted_in, r, batch, smem, st,
                static_cast<const T*>(x), static_cast<T*>(s),
                static_cast<T*>(c));
}

template <typename T>
int dot_dispatch(int scheme, const void* a, const void* b, void* s, void* c,
                 const Ring& r, long long batch, long long smem,
                 cudaStream_t st) {
  if (!plan_ok(r, batch, smem, 2, sizeof(T), a, b))
    return (int)cudaErrorInvalidValue;
  switch (scheme) {
    case NAIVE: return dot_one<NAIVE, T>(a, b, s, c, r, batch, smem, st);
    case KAHAN: return dot_one<KAHAN, T>(a, b, s, c, r, batch, smem, st);
    case PAIRWISE: return dot_one<PAIRWISE, T>(a, b, s, c, r, batch, smem, st);
    case DOT2: return dot_one<DOT2, T>(a, b, s, c, r, batch, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int sum_dispatch(int scheme, const void* x, void* s, void* c, const Ring& r,
                 long long batch, long long smem, cudaStream_t st) {
  if (!plan_ok(r, batch, smem, 1, sizeof(T), x, x))
    return (int)cudaErrorInvalidValue;
  switch (scheme) {
    case NAIVE: return sum_one<NAIVE, T>(x, s, c, r, batch, smem, st);
    case KAHAN: return sum_one<KAHAN, T>(x, s, c, r, batch, smem, st);
    case PAIRWISE: return sum_one<PAIRWISE, T>(x, s, c, r, batch, smem, st);
    case DOT2: return sum_one<DOT2, T>(x, s, c, r, batch, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points. dtype: 0 = float32, 1 = float64, 2 = bfloat16. The plan
// (chains a CTA, depth, stages, shared bytes) comes from the host's
// reduce_plan; copy = 1 takes 16-byte cp.async (every operand 16-byte
// aligned), 0 one element a copy. A plan that is not one of the kernel's,
// whose bytes disagree with the layout or exceed 232448, an unknown copy
// path, or 16-byte copies from a misaligned operand, is refused
// (cudaErrorInvalidValue, nothing launched). Each returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int kahan_dot_launch(int scheme, int dtype, const void* a,
                                const void* b, void* s, void* c,
                                long long batch, long long n, int cells,
                                int chains, int depth, int stages,
                                long long smem, int copy, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Ring r{n, cells, chains, depth, stages, copy};
  if (dtype == 0) return dot_dispatch<float>(scheme, a, b, s, c, r, batch, smem, st);
  if (dtype == 1) return dot_dispatch<double>(scheme, a, b, s, c, r, batch, smem, st);
  if (dtype == 2) return dot_dispatch<Bf16>(scheme, a, b, s, c, r, batch, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int kahan_sum_launch(int scheme, int dtype, const void* x, void* s,
                                void* c, long long batch, long long n,
                                int cells, int chains, int depth, int stages,
                                long long smem, int copy, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Ring r{n, cells, chains, depth, stages, copy};
  if (dtype == 0) return sum_dispatch<float>(scheme, x, s, c, r, batch, smem, st);
  if (dtype == 1) return sum_dispatch<double>(scheme, x, s, c, r, batch, smem, st);
  if (dtype == 2) return sum_dispatch<Bf16>(scheme, x, s, c, r, batch, smem, st);
  return (int)cudaErrorInvalidValue;
}

#!/usr/bin/env python3
"""How fast the H100 rounds a float to bfloat16, and which roundings give
the same bits: the choice behind the bfloat16 flash kernel's rounding
(``csrc/schemes.cuh::Bf16f``).

    python3 scripts/bf16_rounding.py [--out FILE.jsonl]

A bfloat16 op of the port is computed in float and rounded to bfloat16
once. Held as a float (the bfloat16 bits in the upper half), one op costs
its float op plus one rounding. The script builds a small CUDA source with
the port's flags (``-ftz=true -fmad=false``, sm_90a) and times, at full
occupancy, 16 independent chains a thread of ``s = s * a + b`` (a float
multiply and add) under each rounding after every op:

- ``none``: no rounding (the float32 chain);
- ``cvt``: ``cvt.rn.bf16x2.f32 d, x, 0`` (F2FP.BF16.F32.PACK_AB with a
  zero low half), whose 32 bits are the rounded value as a float;
- ``int``: round to nearest even on the bits, ``(u + 0x7fff + ((u >> 16)
  & 1)) & 0xffff0000``, on the integer pipe;
- ``mixed``: ``cvt`` after the multiply, ``int`` after the add;
- ``cvt_pair``: one ``cvt.rn.bf16x2.f32`` for the products of two chains,
  then both halves widened again.

Each row gives the chain steps an SM completes a clock (from the SM clock
that ``nvidia-smi`` reads under the load) and the time against ``none``.
Then every one of the 2^32 float bit patterns is rounded by ``cvt`` and
by ``int``: the counts of patterns whose bits differ, split into normal,
subnormal, infinite and NaN inputs, must be zero outside NaN for ``int``
to stand in for ``cvt``. Needs one CUDA card and ``nvcc``; prints one JSON
object a line (card first).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.kernels import _build  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ float rnd_cvt(float x) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(x), "f"(0.0f));
  return __uint_as_float(u);
}
__device__ __forceinline__ float rnd_int(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}
__device__ __forceinline__ void rnd_pair(float& x, float& y) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(x), "f"(y));
  x = __uint_as_float(u & 0xffff0000u);
  y = __uint_as_float(u << 16);
}

constexpr int kChains = 16;

template <int MODE>
__global__ void __launch_bounds__(256) chains(const float* in, float* out,
                                              int iters) {
  const float a = in[threadIdx.x & 31], b = in[32 + (threadIdx.x & 31)];
  float s[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) s[i] = in[64 + i] + threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; i += 2) {
      float p0 = s[i] * a, p1 = s[i + 1] * a;
      if (MODE == 1 || MODE == 3) { p0 = rnd_cvt(p0); p1 = rnd_cvt(p1); }
      if (MODE == 2) { p0 = rnd_int(p0); p1 = rnd_int(p1); }
      if (MODE == 4) rnd_pair(p0, p1);
      float t0 = p0 + b, t1 = p1 + b;
      if (MODE == 1) { t0 = rnd_cvt(t0); t1 = rnd_cvt(t1); }
      if (MODE == 2 || MODE == 3) { t0 = rnd_int(t0); t1 = rnd_int(t1); }
      if (MODE == 4) rnd_pair(t0, t1);
      s[i] = t0;
      s[i + 1] = t1;
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kChains; ++i) acc += s[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// counts[0..3]: patterns whose cvt and int roundings differ, by class of
// the input (normal or zero, subnormal, infinite, NaN)
__global__ void compare(unsigned long long* counts) {
  const unsigned long long n = 1ull << 32;
  unsigned long long local[4] = {0, 0, 0, 0};
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned u = (unsigned)i;
    const float x = __uint_as_float(u);
    if (__float_as_uint(rnd_cvt(x)) != __float_as_uint(rnd_int(x))) {
      const unsigned e = (u >> 23) & 0xff, m = u & 0x7fffff;
      const int cls = e == 0xff ? (m ? 3 : 2) : (e == 0 && m ? 1 : 0);
      ++local[cls];
    }
  }
  for (int c = 0; c < 4; ++c)
    if (local[c]) atomicAdd(&counts[c], local[c]);
}

extern "C" int run_chains(int mode, const float* in, float* out, int blocks,
                          int iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: chains<0><<<blocks, 256, 0, st>>>(in, out, iters); break;
    case 1: chains<1><<<blocks, 256, 0, st>>>(in, out, iters); break;
    case 2: chains<2><<<blocks, 256, 0, st>>>(in, out, iters); break;
    case 3: chains<3><<<blocks, 256, 0, st>>>(in, out, iters); break;
    default: chains<4><<<blocks, 256, 0, st>>>(in, out, iters); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int run_compare(unsigned long long* counts, void* stream) {
  compare<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(counts);
  return (int)cudaGetLastError();
}
"""

MODES = ("none", "cvt", "int", "mixed", "cvt_pair")


def build(out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "bf16_rounding.cu"
    src.write_text(SOURCE)
    lib = out_dir / "libbf16_rounding.so"
    flags = [f for f in _build.NVCC_FLAGS]
    subprocess.run([_build.nvcc(), *flags, "-Xptxas", "-v", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    v, i = ctypes.c_void_p, ctypes.c_int
    so.run_chains.argtypes = (i, v, v, i, i, v)
    so.run_compare.argtypes = (v, v)
    return so


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_rounding: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [{"card": card, "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    lib = build(ROOT / "build" / "bf16_rounding")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    inp = torch.rand(96, device=dev) + 0.5
    blocks = sms * 8                          # 2048 threads an SM
    out = torch.empty(blocks * 256, device=dev)
    stream = _build.stream_ptr(dev)
    iters = 1 << 14

    def launch(mode):
        _build.check(lib.run_chains(mode, inp.data_ptr(), out.data_ptr(),
                                    blocks, iters, stream), "chains")

    base = None
    for mode, name in enumerate(MODES):
        for _ in range(3):
            launch(mode)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reps = 10
        start.record()
        for _ in range(reps):
            launch(mode)
        end.record()
        clock = sm_clock_mhz()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        steps = blocks * 256 * 16 * iters
        per_clk = steps / sms / (ms * 1e-3 * clock * 1e6)
        base = base or ms
        row = {"rounding": name, "ms": ms, "sm_clock_mhz": clock,
               "chain_steps_per_sm_clock": per_clk, "over_none": ms / base}
        lines.append(row)
        print(json.dumps(row), flush=True)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    _build.check(lib.run_compare(counts.data_ptr(), stream), "compare")
    torch.cuda.synchronize()
    row = dict(zip(("differ_normal", "differ_subnormal", "differ_inf",
                    "differ_nan"), counts.tolist()))
    lines.append(row)
    print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build and bind the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

The library is compiled from ``repro_torch/csrc/<name>.cu`` (with the
shared headers ``csrc/*.cuh``) at first use, into ``build/kernels/`` at
the root of the checkout, and reused while its sources are unchanged (the
file name carries a hash of the source, the headers and the flags). Nothing is built when a module is imported, and nothing falls
back: a missing ``nvcc``, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"

#: contraction off: the kernels place their fused multiply-adds by hand
#: (``__fmaf_rn`` / ``__fma_rn``) at exactly the reference's fused sites,
#: and nowhere else (the flash and matmul chains have none). ``-ftz=true``:
#: float32 arithmetic flushes subnormal inputs and results to zeros of
#: their sign, as XLA on the CPU does for the reference (bfloat16 is
#: computed in float32, so it flushes too; float64 does not flush, and
#: float64 results of float32 or bfloat16 data never reach its subnormal
#: range).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-ftz=true", "-shared", "-Xcompiler",
              "-fPIC")

_V, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_P = ctypes.POINTER(ctypes.c_int)
#: C entry points of each library, with their argument types.
_SIGNATURES = {
    "kahan_reduce": {
        # (scheme, dtype, a, b, s, c, batch, n, cells, chains, depth,
        #  stages, smem_bytes, copy, stream)
        "kahan_dot_launch": (_I, _I, _V, _V, _V, _V, _LL, _LL, _I, _I, _I,
                             _I, _LL, _I, _V),
        # (scheme, dtype, x, s, c, batch, n, cells, chains, depth, stages,
        #  smem_bytes, copy, stream)
        "kahan_sum_launch": (_I, _I, _V, _V, _V, _LL, _LL, _I, _I, _I, _I,
                             _LL, _I, _V),
        # (dtype, x, s, c, rows, cols, stream)
        "kahan_sq_columns_launch": (_I, _V, _V, _V, _LL, _LL, _V),
    },
    "kahan_flash": {
        # (scheme, dtype, q, k, v, l_s, l_c, a_s, a_c, bh, q_groups, sq,
        #  skv, dh, block_k, kv_len, q_off, causal, scale, rows,
        #  smem_bytes, stream)
        "kahan_flash_launch": (_I, _I, _V, _V, _V, _V, _V, _V, _V, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, ctypes.c_double,
                               _I, _LL, _V),
    },
    "kahan_matmul": {
        # (scheme, dtype, a_dtype, b_dtype, a, b, s, c, batch, m, n, k,
        #  block_k, tm, split, stream)
        "kahan_matmul_launch": (_I, _I, _I, _I, _V, _V, _V, _V, _I, _I, _I,
                                _I, _I, _I, _I, _V),
        # (dtype, batch, m, n, k, block_k, *tm, *tn, *split)
        "kahan_matmul_plan": (_I, _I, _I, _I, _I, _I, _P, _P, _P),
    },
}

#: dtype codes of the C entry points.
DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from csrc/ at first use and need the CUDA toolkit")
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/kernels/lib<name>-<hash>.so``
    unless that file exists; returns its path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)        # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built at first use), with argument
    and return types declared for every entry point."""
    if name not in _LOADED:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return _LOADED[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` (a plan's input)."""
    return torch.cuda.get_device_properties(device).multi_processor_count

"""The yardstick: the H100's published peaks, the union of device
intervals, and the operations and bytes a training step needs, counted
from the configuration's shapes.

Peaks are NVIDIA's H100 SXM data sheet, dense, at 700 W: 989 TFLOP/s in
bfloat16 and float16 on the tensor cores, 67 TFLOP/s in float32 outside
them, 67 TFLOP/s in float64 on the FP64 tensor cores, and 3.35 TB/s of
HBM3.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 67e12}
HBM_BYTES_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Nanoseconds covered by the ``(start, duration)`` intervals: time in
    which at least one of them ran, overlaps counted once."""
    total, end = 0, None
    for start, dur in sorted(intervals):
        stop = start + dur
        if end is None or start > end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def step_flops(fam, cfg: Dict, traffic: Dict) -> float:
    """Model FLOPs of one training step: 6 x the weights a token multiplies
    by x the tokens, plus 3 x the forward pass's causal attention
    products; no recomputation."""
    seq, rows = traffic["seq_len"], traffic["global_batch"]
    return (6.0 * fam.active_weights(cfg) * seq * rows
            + 3.0 * fam.attention_flops(cfg, seq) * rows)


def matmul_least_s(m: int, n: int, k: int, dtype: str) -> float:
    """The least time of one [M, K] x [K, N] product on the H100: the
    larger of its operands and result moved once over HBM and its 2MNK
    operations at the operands' dtype's peak."""
    size = ITEMSIZE[dtype]
    moved = (m * k + k * n + m * n) * size
    return max(moved / HBM_BYTES_S, 2.0 * m * n * k / PEAK_FLOPS[dtype])


def projection_least_s(fam, cfg: Dict, traffic: Dict, dtype: str) -> float:
    """The least time of a training step's dense projections: for each of
    the family's projections in each microbatch, the forward product and
    the two of its backward pass (the input's gradient, [M, N] x [N, K],
    and the weight's, [K, M] x [M, N]), each priced by
    ``matmul_least_s``; no recomputation."""
    rows = traffic["global_batch"] // traffic["microbatches"]
    m = rows * traffic["seq_len"]
    one = sum(cnt * (matmul_least_s(m, n, k, dtype)
                     + matmul_least_s(m, k, n, dtype)
                     + matmul_least_s(k, n, m, dtype))
              for k, n, cnt in fam.projections(cfg))
    return one * traffic["microbatches"]


def norm_bytes(layout: Dict) -> int:
    """Bytes of the float32 gradient that the global norm's kernels read
    once: every leaf of two or more axes (the others are summed apart)."""
    total = 0
    for spec in layout.values():
        if spec is not None and len(spec[0]) >= 2:
            n = 1
            for s in spec[0]:
                n *= s
            total += 4 * n
    return total


def gaps(events: List[Tuple[int, int, str]], top: int = 10):
    """The ``top`` longest idle stretches between device operations, as
    ``[name, seconds]``, each named by the operations on either side."""
    out, end, last = [], None, None
    for start, dur, name in sorted(events):
        if end is not None and start > end:
            out.append((start - end, f"{last[:60]} -> {name[:60]}"))
        if end is None or start + dur > end:
            end, last = start + dur, name
    out.sort(reverse=True)
    return [[name, ns / 1e9] for ns, name in out[:top]]


def by_name(events: List[Tuple[int, int, str]], top: int = 10):
    """The ``top`` device operations by total time, ``[name, seconds]``."""
    sums: Dict[str, int] = {}
    for _, dur, name in events:
        sums[name] = sums.get(name, 0) + dur
    ranked = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in ranked]

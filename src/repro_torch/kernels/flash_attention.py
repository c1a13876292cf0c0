"""Flash attention with compensated online-softmax accumulators: the
wrappers of the Hopper kernel ``kahan_flash_grid`` (``csrc/kahan_flash.cu``)
and their plain versions.

Counterpart of ``repro/kernels/flash_attention.py``. Flash attention folds
k-blocks into running statistics

    m   <- max(m, rowmax(s))
    l   <- l * exp(m_old - m) + rowsum(p)
    acc <- acc * exp(m_old - m) + p @ v

where ``l`` and ``acc`` each carry a compensated ``(s, c)`` pair folded
once per k-block by ``scheme.update`` (step index = the k-block). The
kernel emits the raw ``(l_s, l_c, acc_s, acc_c)`` grids; the engine
(``kernels/engine.py``) owns padding, promotion and finalization.

``flash_block_update`` is the one k-block body, in torch: the plain
versions below run it per k-block, vectorized over every head-row and
query row, and the kernel repeats its op order on the card. Both
contractions (``q . k`` over ``dh``, ``p . v`` over the k-block) are
single ascending chains of rounded products and rounded adds, so kernel
and plain version agree bit for bit; against the reference they agree to
a tolerance (XLA's ``dot_general`` sums in its own order).

Every compute dtype of the reference runs on the card: q, k and v arrive
promoted to float32, float64 or bfloat16, and the kernel holds the
scores, ``m``, ``l``, ``acc`` and the compensations in that dtype (a
bfloat16 op computed in float32 and rounded once, as torch computes it;
float64's exp is libdevice's, as torch.exp's). Each dtype has a tall tile
and a 16-row one (``flash_plan``).

Which path runs depends only on where the tensors lie: on the CPU the
plain version, on a CUDA tensor the kernel (a scheme without a device
function raises ``NotImplementedError``). Nothing falls back to the plain
version on the card.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple, Union

import torch

from repro_torch.core import kahan as K
from repro_torch.kernels import _build, abstract
from repro_torch.kernels.schemes import CompensationScheme

Tensor = torch.Tensor
Grids = Tuple[Tensor, Tensor, Tensor, Tensor]

NEG_INF = -1e30

#: limits of the CUDA kernel: a lane holds block_k / 32 probabilities of
#: its row in registers for the rowsum tree, and a 16-row CTA's shared
#: memory (``flash_smem_bytes``) fits every dh and block_k up to these
MAX_HEAD_DIM = 256
MAX_BLOCK_K = 1024

#: by the compute dtype's itemsize: the kernel's tile heights (query rows
#: a CTA), largest first, and the most acc cells a CTA holds, rows *
#: round4(dh) (32 a thread, 16 in float64); the depth of its K/V ring, of
#: 64-key sub-tiles (32 in float64's 32-row tile, ``sub_tile_keys``); its
#: shared memory limit
TILE_ROWS = {4: (64, 16), 2: (64, 16), 8: (32, 16)}
TILE_OUTPUTS = {4: 8192, 2: 8192, 8: 4096}
RING_STAGES = 2
SUB_TILE_KEYS = 64
SMEM_LIMIT = 232448


def softmax_scale(dh: int) -> float:
    """``dh ** -0.5`` as a Python float, rounded to the compute dtype
    where it multiplies the scores (by ``scalar_like`` here, by ``T(scale)``
    in the kernel, which takes it as a double), as the reference's weakly
    typed ``dh ** -0.5`` is."""
    return dh ** -0.5


def _round_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _round4(n: int) -> int:
    return _round_to(n, 4)


def sub_tile_keys(rows: int, itemsize: int = 4) -> int:
    """Keys of one K/V sub-tile (a ring stage): 64, but 32 in float64's
    32-row tile, whose 64-key stages would not fit beside its score
    block."""
    return 32 if itemsize == 8 and rows == 32 else SUB_TILE_KEYS


def flash_smem_bytes(rows: int, dh: int, block_k: int,
                     itemsize: int = 4) -> int:
    """Dynamic shared memory of one CTA of ``kahan_flash_grid`` (the
    layout in the source note), in bytes, for a compute dtype of
    ``itemsize`` bytes, ``vec = 16 / e`` elements of ``e`` bytes in 16
    bytes: the q tile ``[rows][ld]``, the score block ``[rows][round_vec(
    block_k) + vec]`` and 4 statistics a row in the compute type's
    elements (``e`` the itemsize, but 4 for bfloat16, whose values are
    held in floats), and ``RING_STAGES`` K/V sub-tiles of ``round_vec(min(
    keys, block_k) * ld)`` elements of the dtype itself (``keys`` from
    ``sub_tile_keys``), with ``ld = dh + vec`` when ``dh % vec == 0``,
    else ``dh + 1``."""
    def ld(e: int) -> int:
        vec = 16 // e
        return dh + vec if dh % vec == 0 else dh + 1

    e = max(itemsize, 4)
    stage = _round_to(min(sub_tile_keys(rows, itemsize), block_k)
                      * ld(itemsize), 16 // itemsize)
    return (e * (rows * ld(e) + rows * (_round_to(block_k, 16 // e)
                                        + 16 // e) + 4 * rows)
            + itemsize * RING_STAGES * stage)


def fitting_tiles(dh: int, block_k: int,
                  itemsize: int = 4) -> List[Tuple[int, int]]:
    """``(rows, smem_bytes)`` of each tile of ``TILE_ROWS[itemsize]``,
    tallest first, that fits a compute dtype of ``itemsize`` bytes at
    these shapes: ``rows * round4(dh) <= TILE_OUTPUTS[itemsize]`` and its
    shared memory at most ``SMEM_LIMIT``."""
    out = []
    for rows in TILE_ROWS[itemsize]:
        smem = flash_smem_bytes(rows, dh, block_k, itemsize)
        if (rows * _round4(dh) <= TILE_OUTPUTS[itemsize]
                and smem <= SMEM_LIMIT):
            out.append((rows, smem))
    return out


@functools.lru_cache(maxsize=None)
def flash_plan(bh: int, sq: int, dh: int, block_k: int,
               sms: int = 132, itemsize: int = 4) -> Tuple[int, int]:
    """``(rows, smem_bytes)`` of a launch on ``BH`` head-rows of ``Sq``
    queries in a compute dtype of ``itemsize`` bytes: the tallest of the
    ``fitting_tiles`` that leaves at least two CTAs per SM (``ceil(Sq /
    rows) * BH >= 2 * sms``), else the shortest. In float32 and bfloat16
    16 rows fit every dh and block_k within the kernel's limits, in
    float64 not all (dh 128 fits block_k up to 512): a block_k that does
    not fit raises ``ValueError``. The row bits do not depend on the plan.
    Cached: the wrapper asks at every launch."""
    fits = fitting_tiles(dh, block_k, itemsize)
    if not fits:
        raise ValueError(f"flash kernel: no tile fits dh={dh}, "
                         f"block_k={block_k} in {itemsize}-byte elements")
    for rows, smem in fits:
        if -(-sq // rows) * bh >= 2 * sms:
            return rows, smem
    return fits[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rowsum_tree(p: Tensor) -> Tensor:
    """``[..., n] -> [..., 1]`` by a power-of-two pairwise tree of
    elementwise adds: zero-pad to a power of two, add halves
    (``repro/kernels/flash_attention.py:55-73``)."""
    n = p.shape[-1]
    p2 = 1 << (n - 1).bit_length()
    if p2 != n:
        p = torch.cat([p, p.new_zeros((*p.shape[:-1], p2 - n))], dim=-1)
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = K.add(p[..., :half], p[..., half:])
    return p


def _scores(q: Tensor, k: Tensor) -> Tensor:
    """``[B, Sq, dh] x [B, bk, dh] -> [B, Sq, bk]``, each entry one
    ascending chain over ``dh`` of rounded products and rounded adds (the
    kernel's order)."""
    s = q.new_zeros((q.shape[0], q.shape[1], k.shape[1]))
    for d in range(q.shape[-1]):
        s = K.add(s, K.mul(q[:, :, d, None], k[:, None, :, d]))
    return s


def _mix(p: Tensor, v: Tensor) -> Tensor:
    """``[B, Sq, bk] x [B, bk, dh] -> [B, Sq, dh]``, ascending over the
    k-block (the kernel's order)."""
    out = p.new_zeros((p.shape[0], p.shape[1], v.shape[-1]))
    for j in range(p.shape[-1]):
        out = K.add(out, K.mul(p[:, :, j, None], v[:, None, j, :]))
    return out


def flash_block_update(scheme: CompensationScheme, q, k, v, m_old, l_s, l_c,
                       a_s, a_c, *, q_pos: Tensor, k_pos: Tensor,
                       kv_len: int, causal: bool, scale: float, step: int):
    """ONE k-block fold of the online-softmax state (the reference's
    ``flash_block_update``, ``flash_attention.py:76-137``).

    q ``[B, Sq, dh]``; k/v ``[B, bk, dh]``; m_old/l_s/l_c ``[B, Sq, 1]``;
    a_s/a_c ``[B, Sq, dh]``; ``q_pos`` ``[Sq, 1]`` and ``k_pos`` ``[1, bk]``
    absolute positions. Returns the updated (m, l_s, l_c, a_s, a_c)."""
    s = _scores(q, k)
    s = K.mul(s, K.scalar_like(scale, s))
    valid = k_pos < kv_len                       # engine-padded keys
    if causal:
        valid = valid & (q_pos >= k_pos)
    s = torch.where(valid, s, NEG_INF)
    m_new = torch.maximum(m_old, s.amax(dim=-1, keepdim=True))
    corr = K.flush(torch.exp(K.sub(m_old, m_new)))
    p = K.flush(torch.exp(K.sub(s, m_new)))
    p_sum = rowsum_tree(p)
    pv = _mix(p, v)
    l_s, l_c = scheme.update(K.mul(l_s, corr), K.mul(l_c, corr), p_sum,
                             step)
    a_s, a_c = scheme.update(K.mul(a_s, corr), K.mul(a_c, corr), pv, step)
    return m_new, l_s, l_c, a_s, a_c


def flash_plain(q: Tensor, k: Tensor, v: Tensor, *,
                scheme: CompensationScheme, block_k: int, kv_len: int,
                causal: bool, q_off: int = 0, q_groups: int = 1) -> Grids:
    """The plain PyTorch version of both kernels: q ``[BH, Sq, dh]``, k/v
    ``[BH // q_groups, Skv, dh]`` (padded, in the compute dtype) -> the
    raw ``(l_s, l_c, acc_s, acc_c)`` grids. A loop over k-blocks; each
    step updates every head-row and query row elementwise, so a row
    rounds exactly as it would alone."""
    bh, sq, dh = q.shape
    skv = k.shape[1]
    q, k, v = K.flush(q), K.flush(k), K.flush(v)
    if q_groups > 1:
        # row bh reads k/v head-row bh // G (pure data movement)
        k = k.repeat_interleave(q_groups, dim=0)
        v = v.repeat_interleave(q_groups, dim=0)
    dev = q.device
    scale = softmax_scale(dh)
    q_pos = (q_off + torch.arange(sq, device=dev))[:, None]
    m = torch.full((bh, sq, 1), NEG_INF, dtype=q.dtype, device=dev)
    l_s = torch.zeros((bh, sq, 1), dtype=q.dtype, device=dev)
    l_c = torch.zeros_like(l_s)
    a_s = torch.zeros_like(q)
    a_c = torch.zeros_like(q)
    for kb in range(skv // block_k):
        lo, hi = kb * block_k, (kb + 1) * block_k
        k_pos = torch.arange(lo, hi, device=dev)[None, :]
        m, l_s, l_c, a_s, a_c = flash_block_update(
            scheme, q, k[:, lo:hi], v[:, lo:hi], m, l_s, l_c, a_s, a_c,
            q_pos=q_pos, k_pos=k_pos, kv_len=kv_len, causal=causal,
            scale=scale, step=kb)
    return l_s, l_c, a_s, a_c


def kept_pairs(sq: int, kv_len: int, q_off: int, causal: bool) -> int:
    """(query, key) pairs a launch computes: under the causal mask query
    ``i`` (at ``q_off + i``) sees ``min(q_off + i + 1, kv_len)`` keys,
    else every one of ``kv_len``."""
    if not causal:
        return sq * kv_len
    full = max(0, min(sq, kv_len - q_off))        # rows before the cap
    first = q_off + 1
    return full * (2 * first + full - 1) // 2 + (sq - full) * kv_len


def _launch(q: Tensor, k: Tensor, v: Tensor, *, block_q: int, block_k: int,
            scheme: CompensationScheme, kv_len: int, causal: bool,
            q_off: int, q_groups: int, counter,
            plan: Optional[Tuple[int, int]] = None) -> Grids:
    """One wrapper call: the plain version on CPU tensors, else one
    counted launch of the kernel under ``plan`` (``flash_plan``'s unless
    given; ``scripts/flash_tiles.py`` times the others)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"flash kernel: want q [BH, Sq, dh] and equal k/v [BH_kv, Skv, "
            f"dh], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, dh = q.shape
    bh_kv, skv, dh_kv = k.shape
    if dh_kv != dh:
        raise ValueError(f"flash kernel: head dims differ: q {dh}, k/v "
                         f"{dh_kv}")
    if q_groups < 1 or bh != bh_kv * q_groups:
        raise ValueError(
            f"flash kernel: q has {bh} head-rows but k/v carry {bh_kv} with "
            f"q_groups={q_groups} (expected BH == BH_kv * q_groups)")
    if sq % block_q or skv % block_k or skv == 0:
        raise ValueError(
            f"flash kernel: Sq={sq} and Skv={skv} must be positive "
            f"multiples of block_q={block_q} and block_k={block_k} (the "
            f"engine pads)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash kernel: dtypes differ: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash kernel: operands on {q.device}, "
                         f"{k.device}, {v.device}")
    if type(q) is not Tensor and abstract.screen(counter.__name__, q, k, v):
        out = (q.new_empty((bh, sq, 1)), q.new_empty((bh, sq, 1)),
               q.new_empty(q.shape), q.new_empty(q.shape))
        abstract.record(counter.__name__,
                        4 * bh * dh * kept_pairs(sq, kv_len, q_off, causal),
                        abstract.nbytes(q, k, v, *out))
        return out
    if q.device.type == "cpu":
        return flash_plain(q, k, v, scheme=scheme, block_k=block_k,
                           kv_len=kv_len, causal=causal, q_off=q_off,
                           q_groups=q_groups)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel: unsupported device {q.device}")
    if scheme.device_id is None:
        raise NotImplementedError(
            f"scheme {scheme.name!r} has no CUDA device function (only the "
            f"built-in schemes do); it runs on CPU tensors only")
    if q.dtype not in _build.DTYPE_CODE:
        raise ValueError(f"flash kernel: compute dtype {q.dtype} is not one "
                         f"of {tuple(_build.DTYPE_CODE)}")
    if dh > MAX_HEAD_DIM or block_k > MAX_BLOCK_K or bh > 65535:
        raise ValueError(
            f"flash kernel: dh={dh}, block_k={block_k}, BH={bh} outside the "
            f"kernel's limits (dh <= {MAX_HEAD_DIM}, block_k <= "
            f"{MAX_BLOCK_K}, BH <= 65535)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel: operands must be contiguous")
    l_s = torch.empty((bh, sq, 1), dtype=q.dtype, device=q.device)
    l_c = torch.empty_like(l_s)
    a_s = torch.empty_like(q)
    a_c = torch.empty_like(q)
    if plan is None:
        plan = flash_plan(bh, sq, dh, block_k, sms=_sm_count(q.device),
                          itemsize=q.element_size())
    lib = _build.library("kahan_flash")
    counter.launches += 1
    counter.plan = plan
    err = lib.kahan_flash_launch(
        scheme.device_id, _build.DTYPE_CODE[q.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), l_s.data_ptr(), l_c.data_ptr(),
        a_s.data_ptr(), a_c.data_ptr(), bh, q_groups, sq, skv, dh, block_k,
        kv_len, q_off, int(causal), softmax_scale(dh), *plan,
        _build.stream_ptr(q.device))
    _build.check(err, "kahan_flash_grid")
    return l_s, l_c, a_s, a_c


def flash_accumulators(q: Tensor, k: Tensor, v: Tensor, *, block_q: int,
                       block_k: int, scheme: CompensationScheme, causal: bool,
                       kv_len: int, q_groups: int = 1) -> Grids:
    """The flash grid: q ``[BH, Sq, dh]``, k/v ``[BH // q_groups, Skv,
    dh]``, promoted and padded to block multiples by the engine (padded
    keys masked by ``kv_len``) -> raw ``(l_s, l_c, acc_s, acc_c)``, l
    ``[BH, Sq, 1]`` and acc ``[BH, Sq, dh]``. Replaces
    ``repro/kernels/flash_attention.py:262``."""
    return _launch(q, k, v, block_q=block_q, block_k=block_k, scheme=scheme,
                   kv_len=kv_len, causal=causal, q_off=0, q_groups=q_groups,
                   counter=flash_accumulators)


def flash_chunk_accumulators(q: Tensor, k: Tensor, v: Tensor, q_off: int, *,
                             block_q: int, block_k: int,
                             scheme: CompensationScheme, kv_len: int,
                             q_groups: int = 1) -> Grids:
    """The chunked-prefill grid: a chunk of queries ``[BH, W, dh]`` at
    absolute positions ``q_off + i`` attends the whole cache ``[BH //
    q_groups, Skv, dh]``, causal on absolute positions. Same block body
    as ``flash_accumulators``, so rows whose absolute positions coincide
    with a full-sequence call's are bitwise equal. Replaces
    ``repro/kernels/flash_attention.py:377``."""
    return _launch(q, k, v, block_q=block_q, block_k=block_k, scheme=scheme,
                   kv_len=kv_len, causal=True, q_off=int(q_off),
                   q_groups=q_groups, counter=flash_chunk_accumulators)


#: kernel launches made by each wrapper (chip_smoke.py reads and resets
#: them to show which path ran), and the plan of each one's last launch
flash_accumulators.launches = 0
flash_chunk_accumulators.launches = 0
flash_accumulators.plan = None
flash_chunk_accumulators.plan = None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, block_q: int = 256,
                    block_k: int = 256,
                    scheme: Union[str, CompensationScheme, None] = None,
                    causal: bool = True, q_groups: int = 1) -> Tensor:
    """q ``[BH, Sq, dh]``; k/v ``[BH // q_groups, Skv, dh]`` -> ``[BH, Sq,
    dh]`` in the engine's compute dtype. A veneer over
    ``CompensatedReduction.flash_attention``, which owns padding,
    promotion and finalization. ``scheme``: name / CompensationScheme /
    Policy / None (the ambient policy)."""
    from repro_torch.kernels.engine import CompensatedReduction

    return CompensatedReduction(scheme=scheme).flash_attention(
        q, k, v, block_q=block_q, block_k=block_k, causal=causal,
        q_groups=q_groups)


def flash_chunk_attention(q: Tensor, k: Tensor, v: Tensor, *, q_off: int,
                          block_q: int = 256, block_k: int = 256,
                          scheme: Union[str, CompensationScheme, None] = None,
                          q_groups: int = 1) -> Tensor:
    """Chunked-prefill veneer: q ``[BH, W, dh]`` at absolute offset
    ``q_off`` attends the whole cached k/v ``[BH // q_groups, Skv, dh]``,
    causal on absolute positions; see
    ``CompensatedReduction.flash_chunk_attention``."""
    from repro_torch.kernels.engine import CompensatedReduction

    return CompensatedReduction(scheme=scheme).flash_chunk_attention(
        q, k, v, q_off=q_off, block_q=block_q, block_k=block_k,
        q_groups=q_groups)

"""Compensated-reduction engine (1-D half), in PyTorch.

Counterpart of ``repro/kernels/engine.py``. One accumulator contract for
every compensated reduction:

    total = s + c            (the ``kahan_step`` sign convention)
    merge = two-sum tree     (``merge_accumulators``: pad to a power of
                              two, fold halves in a fixed order)

``CompensatedReduction`` resolves the scheme, unroll and accumulate dtype
once (from its arguments, else the ambient ``schemes.use_policy``
default), promotes inputs to the accumulate dtype BEFORE padding, pads
with exact zeros to the kernel block ``8U * 128`` (an empty input becomes
one zero block), runs the kernel wrappers and merges their grids. The
merge is plain torch on whatever device the grids are on, as the
reference does it outside Pallas.

Flash attention (``flash_attention`` / ``flash_chunk_attention``) runs the
same policy on the online-softmax accumulators: promote q/k/v to the
compute dtype, zero-pad Sq and Skv to the (clamped) blocks, launch the
flash grid (padded keys masked by ``kv_len``), finalize both pairs with
``s + c`` and divide, ``o / max(l, 1e-30)``.

Matmul (``matmul`` / ``batched_matmul``) resolves ``(block_m, block_n,
block_k)`` from the policy's ``blocks`` and clamps them to the problem,
brings each operand to a dtype the kernel widens on load (bf16 weights
stay as they are stored), zero-pads N and K where they are ragged (M
goes as it is: the kernel masks it), launches the matmul grid and
finalizes ``s + c``. ``matmul`` is differentiable: its backward runs the
same compensated kernel with the same blocks; without a gradient to
track it launches directly, with no autograd node.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import kahan as K
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kahan_columns as _kc
from repro_torch.kernels import kahan_dot as _kd
from repro_torch.kernels import kahan_matmul as _km
from repro_torch.kernels import kahan_sum as _ks
from repro_torch.kernels import schemes as _schemes
from repro_torch.kernels.schemes import CompensationScheme, Policy

Tensor = torch.Tensor
LANES = _kd.LANES
SUBLANES = _kd.SUBLANES

SchemeSpec = Union[str, CompensationScheme, Policy, None]

#: every kernel wrapper of the port, by name (launch counters)
WRAPPERS = {
    "dot_accumulators": _kd.dot_accumulators,
    "dot_accumulators_batched": _kd.dot_accumulators_batched,
    "sum_accumulators": _ks.sum_accumulators,
    "sum_accumulators_batched": _ks.sum_accumulators_batched,
    "flash_accumulators": _fa.flash_accumulators,
    "flash_chunk_accumulators": _fa.flash_chunk_accumulators,
    "matmul_accumulators": _km.matmul_accumulators,
    "matmul_accumulators_batched": _km.matmul_accumulators_batched,
    "column_sq_accumulators": _kc.column_sq_accumulators,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# Accumulators and the merge
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Accumulator:
    """A compensated accumulator grid: ``total = s + c`` elementwise.
    ``[rows, lanes]`` for single reductions, ``[batch, rows, lanes]`` for
    batched ones."""

    s: Tensor
    c: Tensor

    def total(self) -> Tensor:
        """Scalar for a ``[rows, lanes]`` grid, ``[batch]`` for a batched
        one (the same tree per row)."""
        if self.s.dim() == 3:
            b = self.s.shape[0]
            return merge_accumulator_grids(
                self.s.reshape(b, -1).T, self.c.reshape(b, -1).T)
        return merge_accumulators(self.s, self.c)


def merge_accumulators(s: Tensor, c: Tensor) -> Tensor:
    """Deterministic compensated merge of an accumulator grid -> scalar:
    flatten, pad to a power of two with zeros, fold halves with two-sum,
    collapse to ``s + c`` (``repro/kernels/engine.py:132-142``)."""
    return merge_accumulator_grids(s.reshape(-1), c.reshape(-1))


def merge_accumulator_grids(s: Tensor, c: Tensor) -> Tensor:
    """The same tree along the leading axis only, elementwise over the
    trailing ones (``repro/kernels/engine.py:145-165``). The grids are
    flushed once here; every level below takes the flushed values that
    the level above wrote."""
    s, c = K.flush(s), K.flush(c)
    n = s.shape[0]
    p2 = 1 << (n - 1).bit_length()
    if p2 != n:
        pad = s.new_zeros((p2 - n, *s.shape[1:]))
        s = torch.cat([s, pad])
        c = torch.cat([c, pad])
    while s.shape[0] > 1:
        half = s.shape[0] // 2
        s, c = K._kahan_combine(s[:half], c[:half], s[half:], c[half:])
    return K.add(s[0], c[0])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompensatedReduction:
    """Shared promotion / padding / merge policy for the compensated
    reductions.

    scheme        registered name, CompensationScheme or Policy (None ->
                  the ambient policy)
    unroll        accumulator-group count U; kernel block (8U, 128)
    blocks        matmul (block_m, block_n, block_k) defaults (None -> the
                  policy's)
    compute_dtype accumulate dtype (None -> the policy's)

    ``last_path`` says which path the latest reduction took: "kernel" (a
    CUDA launch) or "cpu" (the plain version on CPU tensors).
    """

    scheme: SchemeSpec = None
    unroll: Optional[int] = None
    blocks: Optional[Tuple[int, int, int]] = None
    compute_dtype: Any = None
    last_path: str = dataclasses.field(default="", init=False)

    def __post_init__(self):
        spec = self.scheme
        if isinstance(spec, Policy):
            pol = spec
            spec = pol.scheme
        else:
            pol = _schemes.current_policy()
            if spec is None:
                spec = pol.scheme
        self.scheme = _schemes.resolve_scheme(spec)
        if self.unroll is None:
            self.unroll = pol.unroll
        if self.unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {self.unroll}")
        if self.blocks is None:
            self.blocks = pol.blocks
        self.compute_dtype = (
            pol.compute_dtype if self.compute_dtype is None
            else _schemes.resolve_compute_dtype(self.compute_dtype))

    @property
    def block(self) -> int:
        return SUBLANES * self.unroll * LANES

    def _note_path(self, x: Tensor) -> None:
        self.last_path = "cpu" if x.device.type == "cpu" else "kernel"

    # -- promotion + padding (the one place) --------------------------------
    def _prep1d(self, x: Tensor) -> Tensor:
        """Ravel, promote to the compute dtype, zero-pad to the block (an
        empty input becomes one zero block)."""
        x = K.promote(x.reshape(-1), self.compute_dtype)
        pad = (-x.shape[0]) % self.block
        if pad or x.shape[0] == 0:
            pad = pad or self.block
            x = torch.cat([x, x.new_zeros((pad,))])
        return x.contiguous()

    def _prep2d(self, x: Tensor) -> Tensor:
        """[batch, ...] -> [batch, n_padded] in the compute dtype."""
        x = K.promote(x.reshape(x.shape[0], -1),
                      self.compute_dtype)
        pad = (-x.shape[1]) % self.block
        if pad or x.shape[1] == 0:
            pad = pad or self.block
            x = torch.cat([x, x.new_zeros((x.shape[0], pad))], dim=1)
        return x.contiguous()

    # -- accumulator producers ----------------------------------------------
    def dot_accumulators(self, a: Tensor, b: Tensor) -> Accumulator:
        if a.numel() != b.numel():
            raise ValueError(
                f"dot operands must have equal size: {tuple(a.shape)} vs "
                f"{tuple(b.shape)}")
        a, b = self._prep1d(a), self._prep1d(b)
        acc = Accumulator(*_kd.dot_accumulators(
            a, b, scheme=self.scheme, unroll=self.unroll))
        self._note_path(a)
        return acc

    def sum_accumulators(self, x: Tensor) -> Accumulator:
        x = self._prep1d(x)
        acc = Accumulator(*_ks.sum_accumulators(
            x, scheme=self.scheme, unroll=self.unroll))
        self._note_path(x)
        return acc

    def batched_dot_accumulators(self, a: Tensor, b: Tensor) -> Accumulator:
        if a.shape != b.shape:
            raise ValueError(
                f"batched_dot operands must match: {tuple(a.shape)} vs "
                f"{tuple(b.shape)}")
        a, b = self._prep2d(a), self._prep2d(b)
        acc = Accumulator(*_kd.dot_accumulators_batched(
            a, b, scheme=self.scheme, unroll=self.unroll))
        self._note_path(a)
        return acc

    def batched_sum_accumulators(self, x: Tensor) -> Accumulator:
        x = self._prep2d(x)
        acc = Accumulator(*_ks.sum_accumulators_batched(
            x, scheme=self.scheme, unroll=self.unroll))
        self._note_path(x)
        return acc

    # -- collapsed results ---------------------------------------------------
    def dot(self, a: Tensor, b: Tensor) -> Tensor:
        """Compensated dot of two tensors (raveled); compute-dtype scalar."""
        return self.dot_accumulators(a, b).total()

    def asum(self, x: Tensor) -> Tensor:
        """Compensated sum of a tensor (raveled); compute-dtype scalar."""
        return self.sum_accumulators(x).total()

    def batched_dot(self, a: Tensor, b: Tensor) -> Tensor:
        """[batch, n] x [batch, n] -> [batch] in one launch; bitwise equal
        to a loop of ``dot`` calls."""
        return self.batched_dot_accumulators(a, b).total()

    def batched_asum(self, x: Tensor) -> Tensor:
        """[batch, n] -> [batch] in one launch; bitwise equal to a loop of
        ``asum`` calls."""
        return self.batched_sum_accumulators(x).total()

    # -- flash attention -----------------------------------------------------
    def flash_attention(self, q: Tensor, k: Tensor, v: Tensor, *,
                        block_q: int = 256, block_k: int = 256,
                        causal: bool = True, q_groups: int = 1) -> Tensor:
        """Fused attention with compensated online-softmax accumulators.

        q ``[BH, Sq, dh]``; k/v ``[BH // q_groups, Skv, dh]`` (each k/v
        head-row serves ``q_groups`` consecutive query head-rows, never
        repeated). Returns ``[BH, Sq, dh]`` in the compute dtype
        (``repro/kernels/engine.py:419-442``)."""
        l_acc, o_acc, sq = self.flash_attention_accumulators(
            q, k, v, block_q=block_q, block_k=block_k, causal=causal,
            q_groups=q_groups)
        return _finalize_flash(l_acc, o_acc)[:, :sq, :]

    def flash_attention_accumulators(self, q: Tensor, k: Tensor, v: Tensor,
                                     *, block_q: int = 256,
                                     block_k: int = 256, causal: bool = True,
                                     q_groups: int = 1,
                                     ) -> Tuple[Accumulator, Accumulator,
                                                int]:
        """Raw (l, acc) pairs of the flash grid: (l ``[BH, Sq_pad, 1]``, acc
        ``[BH, Sq_pad, dh]``, the un-padded Sq)."""
        q, k, v, block_q, block_k, sq, skv = self._flash_prep(
            "flash_attention", q, k, v, block_q, block_k, q_groups)
        l_s, l_c, o_s, o_c = _fa.flash_accumulators(
            q, k, v, block_q=block_q, block_k=block_k, scheme=self.scheme,
            causal=causal, kv_len=skv, q_groups=q_groups)
        self._note_path(q)
        return Accumulator(l_s, l_c), Accumulator(o_s, o_c), sq

    def flash_chunk_attention(self, q: Tensor, k: Tensor, v: Tensor, *,
                              q_off: int, block_q: int = 256,
                              block_k: int = 256, q_groups: int = 1,
                              ) -> Tensor:
        """Chunked-prefill fused attention: a chunk of queries ``[BH, W,
        dh]`` at absolute positions ``q_off + i`` attends the whole cache
        ``[BH // q_groups, Skv, dh]``, causal on absolute positions (which
        also excludes rows not yet written). Same policy and block body as
        ``flash_attention``, so rows whose absolute positions coincide with
        a full-sequence call's are bitwise equal. Returns ``[BH, W, dh]``
        (``repro/kernels/engine.py:480-504``)."""
        l_acc, o_acc, w = self.flash_chunk_attention_accumulators(
            q, k, v, q_off=q_off, block_q=block_q, block_k=block_k,
            q_groups=q_groups)
        return _finalize_flash(l_acc, o_acc)[:, :w, :]

    def flash_chunk_attention_accumulators(self, q: Tensor, k: Tensor,
                                           v: Tensor, *, q_off: int,
                                           block_q: int = 256,
                                           block_k: int = 256,
                                           q_groups: int = 1,
                                           ) -> Tuple[Accumulator,
                                                      Accumulator, int]:
        """Raw (l, acc) pairs of the chunked-prefill grid. Padded query
        rows run at positions past the chunk; the caller slices them
        off."""
        q, k, v, block_q, block_k, w, skv = self._flash_prep(
            "flash_chunk_attention", q, k, v, block_q, block_k, q_groups)
        l_s, l_c, o_s, o_c = _fa.flash_chunk_accumulators(
            q, k, v, q_off, block_q=block_q, block_k=block_k,
            scheme=self.scheme, kv_len=skv, q_groups=q_groups)
        self._note_path(q)
        return Accumulator(l_s, l_c), Accumulator(o_s, o_c), w

    def _flash_prep(self, what: str, q: Tensor, k: Tensor, v: Tensor,
                    block_q: int, block_k: int, q_groups: int):
        """GQA check, block clamps ``min(bq, round_up(Sq, 8))`` and
        ``min(bk, round_up(Skv, 128))``, promotion to the compute dtype,
        then zero-padding of Sq and Skv to the blocks. Returns the padded
        q, k, v, the blocks and the un-padded Sq and Skv."""
        bh, sq, _ = q.shape
        if bh != k.shape[0] * q_groups:
            raise ValueError(
                f"{what}: q has {bh} head-rows but k/v carry {k.shape[0]} "
                f"with q_groups={q_groups} (expected BH == BH_kv * "
                f"q_groups)")
        skv = k.shape[1]
        block_q = min(block_q, _round_up(sq, 8))
        block_k = min(block_k, _round_up(skv, 128))
        cdt = self.compute_dtype
        q = _pad_rows(K.promote(q, cdt), (-sq) % block_q)
        k = _pad_rows(K.promote(k, cdt), (-skv) % block_k)
        v = _pad_rows(K.promote(v, cdt), (-skv) % block_k)
        return q, k, v, block_q, block_k, sq, skv

    # -- matmul --------------------------------------------------------------
    def _matmul_blocks(self, m: int, n: int, k: int,
                       block_m: Optional[int], block_n: Optional[int],
                       block_k: Optional[int]) -> Tuple[int, int, int]:
        """Resolve and clamp the blocks of an ``(m, k) x (k, n)`` problem:
        ``min(bm, round_up(m, 8))``, ``min(bn, round_up(n, 128))``,
        ``min(bk, round_up(k, 128))`` (``repro/kernels/engine.py:315-326``).
        Unset blocks come from ``self.blocks``."""
        bm, bn, bk = self.blocks
        return (min(bm if block_m is None else block_m, _round_up(m, 8)),
                min(bn if block_n is None else block_n, _round_up(n, 128)),
                min(bk if block_k is None else block_k, _round_up(k, 128)))

    def _prep_matmul(self, a: Tensor, b: Tensor,
                     blocks: Tuple[int, int, int]) -> Tuple[Tensor, Tensor]:
        """Bring both operands to the compute dtype, then zero-pad N and K
        to block multiples (``repro/kernels/engine.py:328-346``, which pads
        M as well: the kernel masks rows past M, and a row's bits do not
        depend on M), for 2-D and batched 3-D operands. An operand the
        kernel widens on load (``kahan_matmul.OPERAND_DTYPES``) keeps its
        dtype: widening is exact, so the grids equal those of operands
        promoted first, and a bf16 weight that needs no padding is used
        where it lies."""
        _, block_n, block_k = blocks
        k, n = b.shape[-2:]
        keep = _km.OPERAND_DTYPES[self.compute_dtype]
        if a.dtype not in keep:
            a = K.promote(a, self.compute_dtype)
        if b.dtype not in keep:
            b = K.promote(b, self.compute_dtype)
        pn, pk = (-n) % block_n, (-k) % block_k
        if pk:
            a = F.pad(a, (0, pk))
        if pk or pn:
            b = F.pad(b, (0, pn, 0, pk))
        return a.contiguous(), b.contiguous()

    def _matmul_grids(self, a: Tensor, b: Tensor,
                      blocks: Tuple[int, int, int]) -> Tuple[Tensor, Tensor]:
        """ONE launch of B5 (2-D operands) or B6 (3-D) at ``blocks``: the
        (s, c) grids ``[..., M, N_pad]``, M as given."""
        a, b = self._prep_matmul(a, b, blocks)
        launch = (_km.matmul_accumulators if a.dim() == 2
                  else _km.matmul_accumulators_batched)
        s, c = launch(a, b, scheme=self.scheme, block_m=blocks[0],
                      block_n=blocks[1], block_k=blocks[2],
                      compute_dtype=self.compute_dtype)
        self._note_path(a)
        return s, c

    def matmul_accumulators(self, a: Tensor, b: Tensor, *,
                            block_m: Optional[int] = None,
                            block_n: Optional[int] = None,
                            block_k: Optional[int] = None) -> Accumulator:
        """(s, c) grids of ``a @ b``, each ``[M_pad, N_pad]`` (padded to
        block multiples, as the reference's; callers slice after
        finalizing). The rows past M are zeros that no thread computes."""
        m, k = a.shape
        if b.dim() != 2 or b.shape[0] != k:
            raise ValueError(f"matmul operands mismatch: {tuple(a.shape)} "
                             f"vs {tuple(b.shape)}")
        blocks = self._matmul_blocks(m, b.shape[1], k, block_m, block_n,
                                     block_k)
        return _padded_rows(self._matmul_grids(a, b, blocks),
                            (-m) % blocks[0])

    def batched_matmul_accumulators(self, a: Tensor, b: Tensor, *,
                                    block_m: Optional[int] = None,
                                    block_n: Optional[int] = None,
                                    block_k: Optional[int] = None,
                                    ) -> Accumulator:
        """(s, c) grids ``[batch, M_pad, N_pad]`` from ONE launch."""
        m, blocks = self._batched_blocks(a, b, block_m, block_n, block_k)
        return _padded_rows(self._matmul_grids(a, b, blocks),
                            (-m) % blocks[0])

    def _batched_blocks(self, a: Tensor, b: Tensor, block_m, block_n,
                        block_k) -> Tuple[int, Tuple[int, int, int]]:
        batch, m, k = a.shape
        if b.dim() != 3 or b.shape[0] != batch or b.shape[1] != k:
            raise ValueError(f"batched_matmul operands mismatch: "
                             f"{tuple(a.shape)} vs {tuple(b.shape)}")
        return m, self._matmul_blocks(m, b.shape[2], k, block_m, block_n,
                                      block_k)

    def matmul(self, a: Tensor, b: Tensor, *, block_m: Optional[int] = None,
               block_n: Optional[int] = None,
               block_k: Optional[int] = None) -> Tensor:
        """``a @ b`` ``[M, K] x [K, N] -> [M, N]`` in the compute dtype,
        with compensated accumulation across K-blocks: one launch on
        unpadded rows. Differentiable: when grad mode is on and an operand
        requires grad, the autograd Function's backward (``da = g @ bᵀ``,
        ``db = aᵀ @ g``) runs the same kernel with this call's clamped
        blocks (``repro/kernels/engine.py:604-654``); otherwise the same
        launch runs with no autograd node."""
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"matmul wants [M, K] x [K, N] operands, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        blocks = self._matmul_blocks(a.shape[0], b.shape[1], a.shape[1],
                                     block_m, block_n, block_k)
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _CompensatedMatmul.apply(a, b, self, blocks)
        return self._finalized_matmul(a, b, blocks)

    def _finalized_matmul(self, a: Tensor, b: Tensor,
                          blocks: Tuple[int, int, int]) -> Tensor:
        s, c = self._matmul_grids(a, b, blocks)
        return _sliced_cols(K.add(s, c), b.shape[-1])

    def batched_matmul(self, a: Tensor, b: Tensor, *,
                       block_m: Optional[int] = None,
                       block_n: Optional[int] = None,
                       block_k: Optional[int] = None) -> Tensor:
        """``[batch, M, K] x [batch, K, N] -> [batch, M, N]`` in one
        launch on unpadded rows, bitwise equal to a loop of ``matmul``
        calls."""
        _, blocks = self._batched_blocks(a, b, block_m, block_n, block_k)
        s, c = self._matmul_grids(a, b, blocks)
        return _sliced_cols(K.add(s, c), b.shape[-1])


class _CompensatedMatmul(torch.autograd.Function):
    """``eng._finalized_matmul`` with a backward through the same
    compensated kernel (the reference's ``custom_vjp``,
    ``repro/kernels/engine.py:640-653``). The backward products take the
    forward's clamped ``blocks``, clamped again to their own shapes."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor, eng: CompensatedReduction,
                blocks: Tuple[int, int, int]):
        ctx.save_for_backward(a, b)
        ctx.eng, ctx.blocks = eng, blocks
        return eng._finalized_matmul(a, b, blocks)

    @staticmethod
    def backward(ctx, g: Tensor):
        a, b = ctx.saved_tensors
        eng, (bm, bn, bk) = ctx.eng, ctx.blocks
        # the kernel reads row-major operands: the transposes are
        # materialized here, in the operands' own dtypes, as XLA
        # materializes them for the reference's kernel; nothing else is
        # copied or widened on the way (a float32 g against bf16 weights
        # is one of the kernel's operand pairs)
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = eng.matmul(g, b.T.contiguous(), block_m=bm, block_n=bn,
                            block_k=bk).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = eng.matmul(a.T.contiguous(), g, block_m=bm, block_n=bn,
                            block_k=bk).to(b.dtype)
        return da, db, None, None


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _padded_rows(grids: Tuple[Tensor, Tensor], pad: int) -> Accumulator:
    """The (s, c) grids with ``pad`` zero rows appended on axis -2."""
    if pad:
        grids = tuple(F.pad(x, (0, 0, 0, pad)) for x in grids)
    return Accumulator(*grids)


def _sliced_cols(x: Tensor, n: int) -> Tensor:
    """``x[..., :n]``, or ``x`` itself when it has no padded column."""
    return x if x.shape[-1] == n else x[..., :n]


def _pad_rows(x: Tensor, pad: int) -> Tensor:
    """Zero rows appended on axis 1 of ``[B, S, dh]``; contiguous."""
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad, x.shape[2]))], dim=1)
    return x.contiguous()


def _finalize_flash(l_acc: Accumulator, o_acc: Accumulator) -> Tensor:
    """``finalize(acc) / max(finalize(l), 1e-30)`` with ``finalize(s, c) =
    s + c``."""
    return K.div(K.add(o_acc.s, o_acc.c),
                 torch.clamp_min(K.add(l_acc.s, l_acc.c), 1e-30))

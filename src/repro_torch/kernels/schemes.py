"""Compensation-scheme registry and the ``Policy`` API, in PyTorch.

Counterpart of ``repro/kernels/schemes.py``. A ``CompensationScheme``
bundles one variant of the compensated reduction loop: the torch
callables ``update(s, c, x, step)`` and ``mul_update(s, c, a, b, step)``
that fold one term into the ``(s, c)`` accumulator pair (``total = s +
c``) and its instruction mix. (The reference's a-priori ``error_bound``
comes with the accuracy benchmark.)

The plain (CPU) versions of the kernels and the oracles in ``ref`` call
these callables. The CUDA kernels cannot call Python, so every built-in
also carries a ``device_id`` that selects the same update, op for op, as
a template instantiation in ``csrc/kahan_reduce.cu``. A scheme registered
at runtime has ``device_id=None``: it runs on CPU tensors (the plain
versions) and raises ``NotImplementedError`` on a CUDA tensor.

Product sites. XLA on the CPU contracts ``a * b + acc`` into one fused
multiply-add wherever the product feeds an add directly: ``naive`` and
``pairwise`` compute ``s = fma(a, b, s)`` and ``kahan`` computes
``y = fma(a, b, c)``. ``dot2``'s split TwoProd and every ``update`` (the
sum path) are not fused. The built-ins' ``mul_update`` place ``fma`` at
exactly those sites, which is what makes the port bitwise equal to the
reference; the CUDA kernels compile with ``-fmad=false`` and call
``__fmaf_rn`` / ``__fma_rn`` at the same two sites. With a bfloat16
accumulate dtype XLA contracts nothing and rounds every op to bfloat16,
so ``_mac`` rounds the product and the add separately there.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.core import kahan as K

Tensor = torch.Tensor
UpdateFn = Callable[[Tensor, Tensor, Tensor, int], Tuple[Tensor, Tensor]]
MulUpdateFn = Callable[[Tensor, Tensor, Tensor, Tensor, int],
                       Tuple[Tensor, Tensor]]

#: accumulate dtypes the kernels support; anything else fails fast at the
#: Policy / engine boundary.
SUPPORTED_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16,
                            "float32": torch.float32,
                            "float64": torch.float64}

#: pairwise cascade interval: the primary accumulator folds into the
#: secondary every FOLD sequential steps.
PAIRWISE_FOLD = 32

#: device ids of the built-in schemes: the ``SCHEME`` template argument of
#: the kernels in ``csrc/kahan_reduce.cu``.
NAIVE_ID, KAHAN_ID, PAIRWISE_ID, DOT2_ID = 0, 1, 2, 3


def resolve_compute_dtype(spec) -> torch.dtype:
    """Normalize an accumulate-dtype spec (torch dtype, numpy dtype or
    name) to a torch dtype; None resolves the ambient policy's. Unsupported
    dtypes fail fast with the menu."""
    if spec is None:
        return current_policy().compute_dtype
    if isinstance(spec, torch.dtype):
        name = str(spec).removeprefix("torch.")
    else:
        name = getattr(spec, "name", None) or getattr(spec, "__name__", None) \
            or str(spec)
    if name not in SUPPORTED_COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {list(SUPPORTED_COMPUTE_DTYPES)}; "
            f"got {name!r}")
    return SUPPORTED_COMPUTE_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class InstructionMix:
    """Adds and muls per scalar iteration of the scheme's dot loop (the
    paper's accounting unit)."""

    adds: int
    muls: int

    @property
    def flops(self) -> int:
        return self.adds + self.muls


@dataclasses.dataclass(frozen=True)
class CompensationScheme:
    """One variant of the compensated reduction loop.

    ``update`` / ``mul_update`` are elementwise torch callables; ``step``
    is the sequential step index (a Python int). ``device_id`` selects the
    CUDA kernels' instantiation of the same update; None means the scheme
    has no device function and runs on CPU tensors only.
    """

    name: str
    update: UpdateFn
    instruction_mix: InstructionMix
    mul_update: Optional[MulUpdateFn] = None
    device_id: Optional[int] = None
    description: str = ""

    def __post_init__(self):
        if not isinstance(self.instruction_mix, InstructionMix):
            raise TypeError(
                f"scheme {self.name!r}: instruction_mix must be an "
                f"InstructionMix, got {type(self.instruction_mix).__name__}")
        if self.mul_update is None:
            upd = self.update
            object.__setattr__(
                self, "mul_update",
                lambda s, c, a, b, step, _u=upd: _u(s, c, a * b, step))


# ---------------------------------------------------------------------------
# Built-in schemes (reference op order, ``repro/kernels/schemes.py:250-288``)
# ---------------------------------------------------------------------------

def _mac(a, b, acc):
    """``a * b + acc`` at a fused site: one rounding in float32 / float64,
    where the reference contracts it; product and add rounded separately
    in bfloat16, where it does not."""
    if acc.dtype == torch.bfloat16:
        return a * b + acc
    return K.fma(a, b, acc)


def _naive_update(s, c, x, step):
    return s + x, c


def _naive_mul_update(s, c, a, b, step):
    return _mac(a, b, s), c


def _kahan_update(s, c, x, step):
    return K.kahan_step(s, c, x)


def _kahan_mul_update(s, c, a, b, step):
    y = _mac(a, b, c)
    t = s + y
    return t, y - (t - s)


def _pairwise_fold(s, c, step):
    if step % PAIRWISE_FOLD == PAIRWISE_FOLD - 1:
        return torch.zeros_like(s), c + s
    return s, c


def _pairwise_update(s, c, x, step):
    return _pairwise_fold(s + x, c, step)


def _pairwise_mul_update(s, c, a, b, step):
    return _pairwise_fold(_mac(a, b, s), c, step)


def _dot2_update(s, c, x, step):
    s, e = K.two_sum(s, x)
    return s, c + e


def _dot2_mul_update(s, c, a, b, step):
    p, ep = K.two_prod(a, b)
    s, es = K.two_sum(s, p)
    return s, c + (ep + es)


NAIVE = CompensationScheme(
    name="naive", update=_naive_update, mul_update=_naive_mul_update,
    instruction_mix=InstructionMix(adds=1, muls=1),
    device_id=NAIVE_ID,
    description="s += a*b (paper Fig. 1a); error grows O(n)")

KAHAN = CompensationScheme(
    name="kahan", update=_kahan_update, mul_update=_kahan_mul_update,
    instruction_mix=InstructionMix(adds=4, muls=1),
    device_id=KAHAN_ID,
    description="compensated accumulation (paper Fig. 1b); O(eps) sum error")

PAIRWISE = CompensationScheme(
    name="pairwise", update=_pairwise_update, mul_update=_pairwise_mul_update,
    instruction_mix=InstructionMix(adds=2, muls=1),
    device_id=PAIRWISE_ID,
    description="two-level cascaded accumulation (streaming pairwise)")

DOT2 = CompensationScheme(
    name="dot2", update=_dot2_update, mul_update=_dot2_mul_update,
    instruction_mix=InstructionMix(adds=13, muls=4),
    device_id=DOT2_ID,
    description="TwoProd+TwoSum (Ogita-Rump-Oishi Dot2); twice-precision")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, CompensationScheme] = {}


def register(scheme: CompensationScheme, *, override: bool = False,
             ) -> CompensationScheme:
    """Add a scheme to the registry; ``override=True`` replaces a name."""
    if not isinstance(scheme, CompensationScheme):
        raise TypeError(f"expected CompensationScheme, got {type(scheme)!r}")
    if scheme.name in _REGISTRY and not override:
        raise ValueError(
            f"scheme {scheme.name!r} already registered "
            f"(pass override=True to replace)")
    _REGISTRY[scheme.name] = scheme
    return scheme


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get(name: str) -> CompensationScheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown compensation scheme {name!r}; registered schemes: "
            f"{sorted(_REGISTRY)}") from None


for _s in (NAIVE, KAHAN, PAIRWISE, DOT2):
    register(_s)


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Policy:
    """Frozen per-call-site configuration for the compensated reductions.

    scheme         registered scheme name or a CompensationScheme object
    unroll         accumulator-group count U; the kernel block is (8U, 128)
    blocks         matmul (block_m, block_n, block_k) tile sizes
    compute_dtype  accumulate dtype: float32 (default) | float64 | bfloat16
    """

    scheme: Union[str, CompensationScheme] = "kahan"
    unroll: int = 8
    blocks: Tuple[int, int, int] = (256, 256, 512)
    compute_dtype: Any = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "scheme", resolve_scheme(self.scheme))
        object.__setattr__(self, "blocks", tuple(int(b) for b in self.blocks))
        object.__setattr__(self, "compute_dtype", resolve_compute_dtype(
            torch.float32 if self.compute_dtype is None
            else self.compute_dtype))
        if self.unroll < 1:
            raise ValueError(f"Policy.unroll must be >= 1, got {self.unroll}")
        if len(self.blocks) != 3 or min(self.blocks) < 1:
            raise ValueError(f"Policy.blocks must be three positive sizes "
                             f"(block_m, block_n, block_k), got {self.blocks}")


def resolve_scheme(spec: Union[str, CompensationScheme, None],
                   ) -> CompensationScheme:
    """str -> registry lookup (fail-fast); scheme -> itself; None -> the
    ambient policy's scheme."""
    if spec is None:
        return current_policy().scheme
    if isinstance(spec, CompensationScheme):
        return spec
    if isinstance(spec, str):
        return get(spec)
    raise TypeError(
        f"scheme must be a name, CompensationScheme, or None; got {spec!r}")


_POLICY: contextvars.ContextVar[Policy] = contextvars.ContextVar(
    "repro_torch_policy")
_DEFAULT_POLICY = Policy()


def current_policy() -> Policy:
    """The ambient Policy (innermost ``use_policy``, else the default)."""
    return _POLICY.get(_DEFAULT_POLICY)


@contextlib.contextmanager
def use_policy(policy: Optional[Policy] = None, /, **overrides):
    """Install a Policy (or field overrides on the ambient one) as the
    context default."""
    if policy is None:
        policy = dataclasses.replace(current_policy(), **overrides)
    elif overrides:
        raise TypeError("pass a Policy or field overrides, not both")
    elif not isinstance(policy, Policy):
        raise TypeError(f"expected Policy, got {type(policy)!r}")
    token = _POLICY.set(policy)
    try:
        yield policy
    finally:
        _POLICY.reset(token)

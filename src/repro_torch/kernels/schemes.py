"""Compensation-scheme registry and the ``Policy`` API, in PyTorch.

Counterpart of ``repro/kernels/schemes.py``. A ``CompensationScheme``
bundles one variant of the compensated reduction loop: the torch
callables ``update(s, c, x, step)`` and ``mul_update(s, c, a, b, step)``
that fold one term into the ``(s, c)`` accumulator pair (``total = s +
c``), its a-priori ``error_bound`` for a length-``n`` dot of condition
``cond`` and its instruction mix (canonical and traced counts, which
``repro_torch.core.ecm`` builds its kernel tables from), validated at
construction and at ``register()``.

The plain (CPU) versions of the kernels and the oracles in ``ref`` call
these callables. The CUDA kernels cannot call Python, so every built-in
also carries a ``device_id`` that selects the same update, op for op, as
a template instantiation in ``csrc/kahan_reduce.cu``. A scheme registered
at runtime has ``device_id=None``: it runs on CPU tensors (the plain
versions) and raises ``NotImplementedError`` on a CUDA tensor.

Product sites. XLA on the CPU contracts ``a * b + acc`` into one fused
multiply-add wherever the product feeds an add directly: ``naive`` and
``pairwise`` compute ``s = fma(a, b, s)`` and ``kahan`` computes
``y = fma(a, b, c)``; ``dot2``'s split TwoProd contracts the four
products of its error term (``core.kahan._two_prod_fused``: those
products are exact in the normal range, so only subnormal-reaching data
tells). Every ``update`` (the sum path) is unfused. The built-ins'
``mul_update`` place ``fma`` at exactly those sites, which is what makes
the port bitwise equal to the reference; the CUDA kernels compile with
``-fmad=false`` and call ``__fmaf_rn`` / ``__fma_rn`` at the same sites.
With a bfloat16 accumulate dtype XLA contracts nothing and rounds every
op to bfloat16, so ``core.kahan._mac`` rounds the product and the add
separately there.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.core import kahan as K

Tensor = torch.Tensor
UpdateFn = Callable[[Tensor, Tensor, Tensor, int], Tuple[Tensor, Tensor]]
MulUpdateFn = Callable[[Tensor, Tensor, Tensor, Tensor, int],
                       Tuple[Tensor, Tensor]]

#: fp32 unit roundoff, the default for ``error_bound``.
EPS32 = 2.0 ** -24
#: f64 unit roundoff (``compute_dtype="float64"``).
EPS64 = 2.0 ** -53
#: bf16 unit roundoff (``compute_dtype="bfloat16"``).
EPS_BF16 = 2.0 ** -8

#: accumulate dtypes the kernels support; anything else fails fast at the
#: Policy / engine boundary.
SUPPORTED_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16,
                            "float32": torch.float32,
                            "float64": torch.float64}

_EPS_BY_DTYPE = {torch.bfloat16: EPS_BF16, torch.float32: EPS32,
                 torch.float64: EPS64}

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


def unit_roundoff(compute_dtype) -> float:
    """Unit roundoff of a supported accumulate dtype (for ``error_bound``)."""
    return _EPS_BY_DTYPE[resolve_compute_dtype(compute_dtype)]


@dataclasses.dataclass(frozen=True)
class InstructionMix:
    """Adds and muls per scalar iteration of the scheme's dot loop (the
    paper's accounting unit; useful flops per update is always 2).

    ``adds`` / ``muls`` are the CANONICAL counts, the figures the paper's
    accounting and the ECM tables use. Where the kernel body executes a
    different raw count (dot2's split TwoProd, where the canonical
    accounting assumes an fma), the ``traced_*`` overrides declare it;
    left None they default to the canonical counts.

    * ``traced_adds`` / ``traced_muls``: adds / muls an element of the
      product path (``mul_update``; the dot kernel).
    * ``traced_sum_adds``: adds an element of the sum path (``update``;
      the sum kernel and the matmul / flash fold sites), which has no
      muls.
    """

    adds: int
    muls: int
    traced_adds: Optional[int] = None
    traced_muls: Optional[int] = None
    traced_sum_adds: Optional[int] = None

    @property
    def flops(self) -> int:
        return self.adds + self.muls

    @property
    def traced_dot(self) -> Tuple[int, int]:
        """(adds, muls) the ``mul_update`` body executes an element."""
        return (self.adds if self.traced_adds is None else self.traced_adds,
                self.muls if self.traced_muls is None else self.traced_muls)

    @property
    def traced_sum(self) -> Tuple[int, int]:
        """(adds, muls) the ``update`` body (sum path) executes an
        element."""
        return (self.adds if self.traced_sum_adds is None
                else self.traced_sum_adds, 0)


#: keys accepted when coercing a mapping into an ``InstructionMix``
_MIX_KEYS = ("adds", "muls", "traced_adds", "traced_muls", "traced_sum_adds")
_MIX_REQUIRED = ("adds", "muls")


def validate_instruction_mix(mix, *, scheme_name: str = "?",
                             ) -> InstructionMix:
    """Coerce and validate an ``instruction_mix`` declaration, failing
    fast: an ``InstructionMix`` or a mapping with keys from ``_MIX_KEYS``
    (``adds`` and ``muls`` required); every count a non-negative int.
    Unknown or missing keys and bad counts raise ``ValueError``, any other
    type ``TypeError``."""
    if isinstance(mix, InstructionMix):
        fields = {k: getattr(mix, k) for k in _MIX_KEYS}
    elif isinstance(mix, dict):
        unknown = sorted(set(mix) - set(_MIX_KEYS))
        missing = sorted(set(_MIX_REQUIRED) - set(mix))
        if unknown or missing:
            raise ValueError(
                f"scheme {scheme_name!r}: instruction_mix keys must come "
                f"from {list(_MIX_KEYS)} with {list(_MIX_REQUIRED)} "
                f"required; unknown={unknown} missing={missing}")
        fields = {k: mix.get(k) for k in _MIX_KEYS}
    else:
        raise TypeError(
            f"scheme {scheme_name!r}: instruction_mix must be an "
            f"InstructionMix or a mapping with keys from {list(_MIX_KEYS)}; "
            f"got {type(mix).__name__}")
    for key, val in fields.items():
        required = key in _MIX_REQUIRED
        if val is None and not required:
            continue
        if not isinstance(val, int) or isinstance(val, bool) or val < 0:
            raise ValueError(
                f"scheme {scheme_name!r}: instruction_mix.{key} must be a "
                f"non-negative int{'' if required else ' or None'}; "
                f"got {val!r}")
    return mix if isinstance(mix, InstructionMix) else InstructionMix(**fields)


@dataclasses.dataclass(frozen=True)
class CompensationScheme:
    """One variant of the compensated reduction loop.

    ``update`` / ``mul_update`` are elementwise torch callables; ``step``
    is the sequential step index (a Python int). ``error_bound(n, cond,
    eps=EPS32)`` is the a-priori relative-error bound of a length-``n``
    dot. ``device_id`` selects the CUDA kernels' instantiation of the same
    update; None means the scheme has no device function and runs on CPU
    tensors only.
    """

    name: str
    update: UpdateFn
    instruction_mix: InstructionMix
    error_bound: Callable[..., float]
    mul_update: Optional[MulUpdateFn] = None
    device_id: Optional[int] = None
    description: str = ""

    def __post_init__(self):
        object.__setattr__(
            self, "instruction_mix",
            validate_instruction_mix(self.instruction_mix,
                                     scheme_name=self.name))
        if self.mul_update is None:
            upd = self.update
            object.__setattr__(
                self, "mul_update",
                lambda s, c, a, b, step, _u=upd: _u(s, c, K.mul(a, b), step))


# ---------------------------------------------------------------------------
# Built-in schemes (reference op order, ``repro/kernels/schemes.py:250-288``)
# ---------------------------------------------------------------------------

# The updates take flushed operands (the plain versions flush their
# inputs once) and round every op as the reference does, subnormals
# flushed (``core.kahan``: ``add``, ``sub``, ``mul``).

def _naive_update(s, c, x, step):
    return K.add(s, x), c


def _naive_mul_update(s, c, a, b, step):
    return K._mac(a, b, s), c


def _kahan_update(s, c, x, step):
    return K._kahan_step(s, c, x)


def _kahan_mul_update(s, c, a, b, step):
    y = K._mac(a, b, c)
    t = K.add(s, y)
    return t, K.sub(y, K.sub(t, s))


def _pairwise_fold(s, c, step):
    if step % PAIRWISE_FOLD == PAIRWISE_FOLD - 1:
        return torch.zeros_like(s), K.add(c, s)
    return s, c


def _pairwise_update(s, c, x, step):
    return _pairwise_fold(K.add(s, x), c, step)


def _pairwise_mul_update(s, c, a, b, step):
    return _pairwise_fold(K._mac(a, b, s), c, step)


def _dot2_update(s, c, x, step):
    s, e = K._two_sum(s, x)
    return s, K.add(c, e)


def _dot2_mul_update(s, c, a, b, step):
    p, ep = K._two_prod_fused(a, b)
    s, es = K._two_sum(s, p)
    return s, K.add(c, K.add(ep, es))


def _naive_bound(n: int, cond: float, eps: float = EPS32) -> float:
    # gamma_{n-1} * cond / 2: recursive summation of rounded products.
    return 0.5 * n * eps * cond


def _kahan_bound(n: int, cond: float, eps: float = EPS32) -> float:
    # the compensated sum kills the O(n) term; the rounded products leave
    # the eps * cond / 2 floor (Kahan compensates the sum, not products).
    return (eps + 2.0 * n * eps * eps) * cond


def _pairwise_bound(n: int, cond: float, eps: float = EPS32) -> float:
    # two-level cascade: effective chain length FOLD + n / FOLD.
    eff = PAIRWISE_FOLD + math.ceil(n / PAIRWISE_FOLD)
    return 0.5 * eff * eps * cond


def _dot2_bound(n: int, cond: float, eps: float = EPS32) -> float:
    # twice working precision: eps + gamma^2 * cond (Ogita et al., Prop.
    # 5.4's shape); the cond term surfaces only past cond ~ 1 / eps.
    g = 2.0 * n * eps
    return eps + 0.5 * g * g * cond


NAIVE = CompensationScheme(
    name="naive", update=_naive_update, mul_update=_naive_mul_update,
    instruction_mix=InstructionMix(adds=1, muls=1),
    error_bound=_naive_bound, device_id=NAIVE_ID,
    description="s += a*b (paper Fig. 1a); error grows O(n)")

KAHAN = CompensationScheme(
    name="kahan", update=_kahan_update, mul_update=_kahan_mul_update,
    instruction_mix=InstructionMix(adds=4, muls=1),
    error_bound=_kahan_bound, device_id=KAHAN_ID,
    description="compensated accumulation (paper Fig. 1b); O(eps) sum error")

PAIRWISE = CompensationScheme(
    name="pairwise", update=_pairwise_update, mul_update=_pairwise_mul_update,
    instruction_mix=InstructionMix(adds=2, muls=1),
    error_bound=_pairwise_bound, device_id=PAIRWISE_ID,
    description="two-level cascaded accumulation (streaming pairwise)")

DOT2 = CompensationScheme(
    name="dot2", update=_dot2_update, mul_update=_dot2_mul_update,
    # canonical fma-based Ogita accounting (17 flops an element), the
    # figure the ECM tables use; the split TwoProd executes 18 adds and 7
    # muls an element on the product path, TwoSum alone 7 adds on the sum
    # path (the traced counts)
    instruction_mix=InstructionMix(adds=13, muls=4, traced_adds=18,
                                   traced_muls=7, traced_sum_adds=7),
    error_bound=_dot2_bound, device_id=DOT2_ID,
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
    # again at the registry boundary: dataclasses.replace or
    # object.__setattr__ between construction and registration must not
    # slip a malformed mix into the ECM tables
    validate_instruction_mix(scheme.instruction_mix, scheme_name=scheme.name)
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


def registered() -> Dict[str, CompensationScheme]:
    """A copy of the registry (safe to iterate while registering)."""
    return dict(_REGISTRY)


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

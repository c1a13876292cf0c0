"""Core: the paper's contribution — Kahan-compensated reductions and the
machine model (counterpart of ``repro/core``).

Exports what the reference's ``core`` exports. ``ecm`` and ``numerics``
import no torch, and neither does this package: the compensated
primitives of ``core.kahan`` load at first use of one of their names.
"""

from repro_torch.core import ecm, numerics  # noqa: F401

_KAHAN = ("KahanAccumulator", "compensated_psum_scalar", "fast_two_sum",
          "kahan_combine", "kahan_dot", "kahan_dot2", "kahan_step",
          "kahan_sum", "naive_dot", "naive_sum", "tree_kahan_add",
          "tree_kahan_sq_norm", "two_prod", "two_sum")

__all__ = ["ecm", "numerics", *_KAHAN]


def __getattr__(name):
    if name in _KAHAN:
        from repro_torch.core import kahan

        return getattr(kahan, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

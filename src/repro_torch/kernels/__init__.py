"""Compensated reductions of the port: the scheme registry and Policy
(``schemes``), the Hopper kernels' wrappers with their plain versions
(``kahan_dot``, ``kahan_sum``), the engine (``engine``), its public entry
points (``ops``) and the plain oracles (``ref``)."""

from repro_torch.kernels.schemes import (  # noqa: F401
    CompensationScheme,
    Policy,
    current_policy,
    use_policy,
)

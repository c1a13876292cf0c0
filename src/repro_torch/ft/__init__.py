"""Fault tolerance: failure injection, watchdog, restart supervision."""

from repro_torch.ft.failures import (  # noqa: F401
    FailureInjector,
    SimulatedFailure,
    Watchdog,
    run_with_restarts,
)

"""repro_torch.analysis — the port's three-level engine-contract auditor
(AST + trace + cost), counterpart of ``repro.analysis``.

The repo's numerics contract ("Kahan at no extra cost" holds only while
EVERY hot reduction stays on the compensated engine, and only while the
kernels' instruction mix is the one the ECM model assumes) is checked on
the port at three levels, under the reference's rule ids:

* **AST rules** (:mod:`repro_torch.analysis.rules`) encode the
  source-text clauses over ``src/repro_torch``: raw torch reductions,
  raw all-reduces, device literals, hardcoded accumulate dtypes, host
  syncs in decode/prefill bodies, raw generator seeding.
* **Trace rules** (:mod:`repro_torch.analysis.trace`) audit what the port
  runs: the registered entry points in
  :mod:`repro_torch.analysis.targets` (the ``ops.*`` entries, flash B7/B8
  and its oracle, the serving engine's decode tick and prefill bucket
  programs, the sharded collectives in a fake world, the optimizer norm)
  run once, eagerly, on CPU tensors at tiny shapes, under a recorder
  whose op log is the counterpart of ``jax.make_jaxpr``'s trace.
* **Cost rules** (:mod:`repro_torch.analysis.costmodel`) audit the
  instruction mix each scheme's update executes (counted op for op
  through ``core.kahan``'s op functions) and the bytes the kernel entries
  record, against the declared ``InstructionMix`` and the H100 ECM model;
  with ``--sass`` also against the SASS nvcc makes of the device update
  (``csrc/cost_probe.cu``) and of the shipping kernels
  (:mod:`repro_torch.perf.sass_analysis`).

All levels share one report schema (``Violation`` / ``Pragma`` /
``LintReport``), one exemption-audit trail and one CLI::

    python -m repro_torch.analysis --strict --budget N src/repro_torch
    python -m repro_torch.analysis --trace --strict
    python -m repro_torch.analysis --cost --strict [--sass]
    python -m repro_torch.analysis --list-rules [--trace | --cost]

Intentional exceptions carry a pragma with a mandatory reason, in the
reference's grammar::

    y = x @ w  # contract: allow-no-uncompensated-reduction(cuBLAS projection, as the reference's dense layers)

NOTE: importing :mod:`repro_torch.analysis` (or the AST layer) imports no
torch; the trace and cost layers do and are loaded by the CLI only under
``--trace`` / ``--cost``.
"""

from repro_torch.analysis.core import (  # noqa: F401
    FileContext,
    LintReport,
    Pragma,
    Violation,
    lint_file,
    lint_paths,
    lint_source,
    parse_pragmas,
)
from repro_torch.analysis.rules import Rule, get, names, register, registered  # noqa: F401

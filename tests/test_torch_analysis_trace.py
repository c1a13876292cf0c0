"""repro_torch.analysis, the trace level, on the CPU: the op recorder;
every trace rule fires on a bad artifact (among them what the AST layer
cannot see: an all-reduce whose name is built at run time, a vmapped
decode tick) and stays silent on the registered targets; the registries;
target exemptions audited like pragmas; build failures as findings; the
shared JSON schema; the ``--trace`` CLI; the self-audit; and the rule and
target ids held against the JAX package's."""

import json

import pytest
import torch

from repro_torch.analysis import lint_source, targets, trace
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.report import render_json
from repro_torch.core import kahan as K


def _toy(tags, build=None, exempt=None):
    return targets.Target(
        id="toy.fixture", build=build or (lambda: None),
        tags=tuple(tags), doc="test fixture", exempt=exempt or {})


def _fired(rule_id, tags, art):
    return list(trace.get(rule_id).checker(_toy(tags), art))


def _log(fn, *args):
    return trace.op_log(fn, *args)[0]


# ---------------------------------------------------------------------------
# the op recorder
# ---------------------------------------------------------------------------

def test_record_logs_kahan_ops_as_one_entry_and_aten_ops_outside():
    x = torch.ones(4)

    def f(x):
        y = K.mul(x, x)           # one entry, whatever emulates it
        return torch.exp(y) + 1.0

    names = trace.op_names(_log(f, x))
    assert names[0] == "kahan.mul"
    assert names[1:] == ["aten.exp.default", "aten.add.Tensor"]


def test_record_sees_names_bound_by_import_and_kernel_entries():
    from repro_torch.kernels import ops

    log = _log(ops.matmul, targets.data(8, 8), targets.data(8, 8, seed=1))
    names = trace.op_names(log)
    assert "kernel.matmul_accumulators" in names
    # kahan_matmul binds ``add`` / ``mul`` by name: still one entry each,
    # the emulation's aten multiplies hidden inside them
    assert names.count("kahan.mul") >= 8
    assert "aten.mul.Tensor" not in names


def test_record_marks_regions_and_calls():
    class Box:
        def step(self, x):
            return x + 1.0

    box, x = Box(), torch.ones(2)
    with trace.marking(box, "step", "step", lambda x: (("n", x.numel()),)):
        with trace.record() as log:
            with trace.region("fold", 3):
                box.step(x)
    assert [(op.name, op.region, op.step) for op in log] == [
        ("call.step", "fold", 3), ("aten.add.Tensor", "fold", 3)]
    assert dict(log[0].meta) == {"n": 2}
    assert "step" not in vars(box)          # the mark is gone after


def test_contains_subsequence_is_contiguous():
    assert trace.contains_subsequence(["a", "b", "c", "d"], ["b", "c"])
    assert trace.contains_subsequence(["a"], [])
    assert not trace.contains_subsequence(["a", "b", "c"], ["a", "c"])
    assert not trace.contains_subsequence(["b", "a"], ["a", "b"])


# ---------------------------------------------------------------------------
# trace-no-raw-psum: catches what the AST rule cannot
# ---------------------------------------------------------------------------

def test_no_raw_psum_fires_on_dynamically_named_all_reduce():
    src = ("import torch.distributed as dist\n"
           "def reduce_all(x):\n"
           "    op = getattr(dist, 'all_' + 'reduce')\n"
           "    op(x)\n"
           "    return x\n")
    assert lint_source(src, "distributed/x.py",
                       rule_ids=["no-raw-psum"]).violations == []

    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world

    with fake_world(False):
        op = getattr(dist, "all_" + "reduce")
        log = _log(op, torch.ones(4))
        order_free = _log(lambda x: dist.all_reduce(
            x, op=dist.ReduceOp.MAX), torch.ones(4))
    found = _fired("trace-no-raw-psum", ("sharded",),
                   targets.TraceArtifact(log=log))
    assert found and all(v.path == "toy.fixture" for v in found)
    assert _fired("trace-no-raw-psum", ("sharded",),
                  targets.TraceArtifact(log=order_free)) == []


def test_no_raw_psum_silent_on_registered_collectives():
    report = trace.audit(
        target_ids=["collectives.sharded_asum",
                    "collectives.deterministic_mean"],
        rule_ids=["trace-no-raw-psum"])
    assert report.violations == [], [v.format() for v in report.violations]


def test_sharded_targets_gather_instead():
    art = targets.get("collectives.sharded_dot").build()
    names = trace.op_names(art.log)
    assert "c10d._allgather_base_.default" in names
    assert art.work["dot_accumulators"]["launches"] == 1


# ---------------------------------------------------------------------------
# trace-barrier-pinned
# ---------------------------------------------------------------------------

def _body(x):
    y = K.mul(x, x)
    return K.sub(y, x)


def test_barrier_pinned_fires_when_body_runs_differently():
    x = torch.ones(4)
    body = _log(_body, x)
    kernel = _log(lambda x: K.sub(K.add(x, x), x), x)
    found = _fired("trace-barrier-pinned", ("shared-block",),
                   targets.TraceArtifact(log=kernel, body_log=body))
    assert found and "contiguously" in found[0].message


def test_barrier_pinned_fires_on_an_empty_body():
    found = _fired("trace-barrier-pinned", ("shared-block",),
                   targets.TraceArtifact(log=[], body_log=[]))
    assert found and "ZERO" in found[0].message


def test_barrier_pinned_fires_on_the_oracle_too():
    x = torch.ones(4)
    body = _log(_body, x)
    art = targets.TraceArtifact(log=_log(lambda x: _body(x) * 3.0, x),
                                oracle_log=_log(torch.exp, x), body_log=body)
    (v,) = _fired("trace-barrier-pinned", ("shared-block",), art)
    assert v.message.startswith("oracle")


def test_barrier_pinned_silent_when_body_is_embedded():
    x = torch.ones(4)
    art = targets.TraceArtifact(
        log=_log(lambda x: _body(x) * 3.0, x),
        oracle_log=_log(lambda x: 1.0 + _body(x), x), body_log=_log(_body, x))
    assert _fired("trace-barrier-pinned", ("shared-block",), art) == []


def test_flash_targets_embed_flash_block_update():
    report = trace.audit(target_ids=["kernels.flash_attention",
                                     "kernels.flash_chunk_attention",
                                     "serve.prefill.w4",
                                     "serve.prefill_flash.w4"],
                         rule_ids=["trace-barrier-pinned"])
    assert report.violations == [], [v.format() for v in report.violations]
    art = targets.get("kernels.flash_attention").build()
    assert len(art.body_log) > 50 and art.oracle_log


# ---------------------------------------------------------------------------
# trace-decode-is-scan: the vmapped tick the AST layer cannot flag
# ---------------------------------------------------------------------------

def test_decode_is_scan_fires_on_vmap_engine():
    from repro_torch.serve import EngineConfig, InferenceEngine

    eng = InferenceEngine(
        targets.tiny_arch(),
        EngineConfig(max_slots=3, max_len=16, prefill_chunk=4,
                     slot_loop="vmap"), device=targets.AUDIT_DEVICE)
    fn, args = eng.trace_tick()
    art = targets.TraceArtifact(
        log=targets._marked_log(eng, fn, args),
        slot_positions=tuple(h.pos for _, h in sorted(args[0].items())))
    found = _fired("trace-decode-is-scan", ("decode",), art)
    assert found and "(3, (2, 3, 4))" in found[0].message


def test_decode_is_scan_silent_on_registered_ticks():
    report = trace.audit(target_ids=["serve.decode_tick",
                                     "serve.paged_decode_tick"],
                         rule_ids=["trace-decode-is-scan"])
    assert report.violations == [], [v.format() for v in report.violations]


# ---------------------------------------------------------------------------
# trace-accum-dtype
# ---------------------------------------------------------------------------

def test_accum_dtype_fires_on_a_foreign_dtype():
    log = _log(lambda x: torch.sum(x.to(torch.float16)), torch.ones(8))
    art = targets.TraceArtifact(log=log, compute_dtype=torch.float32)
    found = _fired("trace-accum-dtype", ("kernel",), art)
    assert found and "float16" in found[0].message


def test_accum_dtype_silent_on_registered_ops():
    report = trace.audit(target_ids=["ops.dot", "ops.asum", "ops.matmul"],
                         rule_ids=["trace-accum-dtype"])
    assert report.violations == [], [v.format() for v in report.violations]


# ---------------------------------------------------------------------------
# trace-no-host-callback
# ---------------------------------------------------------------------------

def test_no_host_callback_fires_on_item():
    log = _log(lambda x: (x + 1.0).sum().item(), torch.ones(2))
    found = _fired("trace-no-host-callback", ("serve",),
                   targets.TraceArtifact(log=log))
    assert found and "_local_scalar_dense" in found[0].message


def test_tick_device_work_has_no_host_read_but_the_emit_point_does():
    """The engine's tick is split at its host emit point: the audited
    device work (``_tick``) reads nothing back, while the whole tick
    (with ``_emit``'s sampling) reads each token from the card."""
    from repro_torch.serve import EngineConfig, InferenceEngine

    eng = InferenceEngine(targets.tiny_arch(),
                          EngineConfig(max_slots=2, max_len=16,
                                       prefill_chunk=4, track_stats=True),
                          device=targets.AUDIT_DEVICE)
    fn, (running,) = eng.trace_tick()
    rule = ("trace-no-host-callback", ("serve",))
    assert _fired(*rule, targets.TraceArtifact(log=_log(fn, running))) == []
    whole = _log(eng._decode_tick, running, [])
    assert _fired(*rule, targets.TraceArtifact(log=whole))


def test_no_host_callback_silent_on_registered_serving_logs():
    report = trace.audit(rule_ids=["trace-no-host-callback"])
    assert report.violations == [], [v.format() for v in report.violations]
    assert report.files == 9          # the serve-tagged targets


# ---------------------------------------------------------------------------
# trace-program-count
# ---------------------------------------------------------------------------

def test_program_count_fires_on_unchunked_family():
    from repro_torch.serve.engine import (prefill_program_bound,
                                          prefill_program_family)

    keys = prefill_program_family(16, None, needs_begin=False)
    bound = prefill_program_bound(4, needs_begin=False)
    assert len(keys) > bound
    found = _fired("trace-program-count", ("program-count",),
                   targets.TraceArtifact(program_keys=keys,
                                         program_bound=bound))
    assert found and "O(#buckets)" in found[0].message


def test_program_count_silent_on_registered_families():
    report = trace.audit(target_ids=["serve.prefill_buckets",
                                     "serve.paged_prefill_buckets"],
                         rule_ids=["trace-program-count"])
    assert report.violations == [], [v.format() for v in report.violations]


def test_program_bound_rejects_unchunked_config():
    from repro_torch.serve.engine import prefill_program_bound

    assert prefill_program_bound(4, needs_begin=False) == 3
    assert prefill_program_bound(4, needs_begin=True) == 6
    with pytest.raises(ValueError):
        prefill_program_bound(None, needs_begin=False)


def test_trace_prefill_refuses_a_width_that_is_no_bucket():
    from repro_torch.serve import EngineConfig, InferenceEngine

    eng = InferenceEngine(targets.tiny_arch(),
                          EngineConfig(max_slots=1, max_len=16,
                                       prefill_chunk=4),
                          device=targets.AUDIT_DEVICE)
    with pytest.raises(ValueError, match="no prefill bucket"):
        eng.trace_prefill(3)


# ---------------------------------------------------------------------------
# registries and the audit
# ---------------------------------------------------------------------------

def test_trace_rule_registry_roundtrip():
    rule = trace.TraceRule(id="test-tmp-rule", tags=("kernel",),
                           checker=lambda t, a: iter(()),
                           fix_hint="x", doc="y")
    trace.register(rule)
    try:
        assert trace.get("test-tmp-rule") is rule
        with pytest.raises(ValueError):
            trace.register(rule)
        trace.register(rule, override=True)
    finally:
        trace.unregister("test-tmp-rule")
    with pytest.raises(ValueError):
        trace.get("test-tmp-rule")
    with pytest.raises(TypeError):
        trace.register(object())


def test_target_registry_roundtrip():
    tgt = _toy(("kernel",))
    targets.register(tgt)
    try:
        assert targets.get("toy.fixture") is tgt
        with pytest.raises(ValueError):
            targets.register(tgt)
        targets.register(tgt, override=True)
    finally:
        targets.unregister("toy.fixture")
    with pytest.raises(ValueError):
        targets.get("toy.fixture")
    with pytest.raises(TypeError):
        targets.register("not a target")


def test_rule_applies_by_tag_overlap():
    rule = trace.get("trace-no-raw-psum")
    assert rule.applies_to(_toy(("sharded", "serve")))
    assert not rule.applies_to(_toy(("kernel",)))


def _bad_dtype_art():
    log = _log(lambda x: x.to(torch.float16) * 2, torch.ones(8))
    return targets.TraceArtifact(log=log, compute_dtype=torch.float32)


def test_target_exemption_suppresses_and_is_audited():
    targets.register(_toy(("kernel",), build=_bad_dtype_art,
                          exempt={"trace-accum-dtype": "toy carries fp16"}))
    try:
        report = trace.audit(target_ids=["toy.fixture"],
                             rule_ids=["trace-accum-dtype"])
    finally:
        targets.unregister("toy.fixture")
    assert report.violations == []
    (ex,) = report.exemptions
    assert (ex.rule, ex.path, ex.used, ex.reason) == (
        "trace-accum-dtype", "toy.fixture", True, "toy carries fp16")


def test_target_exemption_stale_when_rule_is_silent():
    clean = targets.TraceArtifact(log=_log(torch.exp, torch.ones(2)))
    targets.register(_toy(("serve",), build=lambda: clean,
                          exempt={"trace-no-host-callback": "left over"}))
    try:
        report = trace.audit(target_ids=["toy.fixture"],
                             rule_ids=["trace-no-host-callback"])
    finally:
        targets.unregister("toy.fixture")
    (ex,) = report.exemptions
    assert ex.used is False


def test_build_failure_becomes_finding_not_crash():
    def boom():
        raise RuntimeError("no such shape")

    targets.register(_toy(("kernel",), build=boom))
    try:
        report = trace.audit(target_ids=["toy.fixture"])
    finally:
        targets.unregister("toy.fixture")
    (v,) = report.violations
    assert v.rule == "trace-build-error" and "no such shape" in v.message
    assert report.exit_code(strict=False) == 1


def test_trace_json_schema_shares_ast_schema():
    report = trace.audit(target_ids=["serve.prefill_buckets"])
    payload = json.loads(render_json(report, budget=0,
                                     rules=trace.registered().values()))
    assert set(payload) == {"files", "violations", "exemptions",
                            "pragma_errors", "rules", "budget"}
    assert payload["budget"] == {"limit": 0, "exemptions": 0, "ok": True}
    by_id = {r["id"]: r for r in payload["rules"]}
    assert by_id["trace-no-raw-psum"]["scope"] == ["sharded"]


def test_trace_cli_exit_codes(capsys):
    assert cli_main(["--trace", "--strict",
                     "--target", "serve.prefill_buckets"]) == 0
    assert cli_main(["--trace", "--target", "no.such.target"]) == 2
    assert "unknown trace target" in capsys.readouterr().err
    assert cli_main(["--target", "no.such.target"]) == 2
    assert cli_main(["--trace", "--rule", "no-such-trace-rule"]) == 2
    assert cli_main(["--trace", "src/repro_torch"]) == 2
    assert cli_main(["--trace", "--cost"]) == 2
    assert cli_main(["--trace", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "trace-no-raw-psum" in out and "serve.decode_tick" in out
    argv = ["--trace", "--target", "serve.prefill_buckets", "--json"]
    assert cli_main(argv + ["--budget", "0"]) == 0
    assert json.loads(capsys.readouterr().out)["budget"]["ok"] is True


# ---------------------------------------------------------------------------
# the self-audit and the reference's ids
# ---------------------------------------------------------------------------

def test_port_trace_self_audit_clean():
    """Every registered target runs and passes every applicable trace
    rule (``python -m repro_torch.analysis --trace --strict``)."""
    assert cli_main(["--trace", "--strict"]) == 0
    report = trace.audit()
    assert report.violations == [], [v.format() for v in report.violations]
    assert report.files == len([t for t in targets.names()
                                if not t.startswith(("cost.", "sass."))])
    assert report.files >= 25


#: the reference's seventh trace rule checks optimized HLO; its
#: counterpart, compiled truth, is the SASS level (``--cost --sass``)
MOVED_TO_SASS = {"trace-barrier-survives-fusion"}


def test_trace_rule_ids_equal_the_references():
    from repro.analysis import trace as jtrace

    assert set(trace.names()) == set(jtrace.names()) - MOVED_TO_SASS
    from repro_torch.analysis import costmodel

    costmodel.register_sass()
    try:
        assert MOVED_TO_SASS <= set(costmodel.names())
    finally:
        costmodel.unregister_sass()


def test_target_ids_equal_the_references():
    from repro.analysis import targets as jtargets

    ref = {t for t in jtargets.names() if not t.startswith("cost.")}
    port = {t for t in targets.names()
            if not t.startswith(("cost.", "sass."))}
    assert port == ref

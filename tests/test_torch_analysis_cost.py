"""repro_torch.analysis, the cost level, on the CPU: the op counters;
every cost rule fires on its bad fixture (a lying ``instruction_mix``,
bytes that miss the resolved dtype, a mix past the H100's hide-point, a
drifted ECM table) and stays silent on the shipped schemes; the SASS
level's parser and rules on synthetic disassembly, and its build error as
a finding where there is no nvcc; the registries and the CLI; the
``--cost --strict`` self-audit; and the counted mixes and bytes held
against the JAX package's ``weighted_op_counts`` at the same shapes."""

import dataclasses
import json

import pytest
import torch

from repro_torch.analysis import costmodel, targets, trace
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.report import render_json
from repro_torch.core import kahan as K
from repro_torch.kernels import schemes
from repro_torch.perf import sass_analysis

BUILTINS = ("naive", "kahan", "pairwise", "dot2")


def _toy_target(tags, build=None, exempt=None):
    return targets.Target(
        id="toy.cost.fixture", build=build or (lambda: None),
        tags=tuple(tags), doc="test fixture", exempt=exempt or {})


def _fired(rule_id, tags, art):
    return list(costmodel.get(rule_id).checker(_toy_target(tags), art))


def _kahan_dot_artifact(**overrides):
    """A CostArtifact consistent with the counted kahan dot (4 adds + 1
    mul an element, 2 float32 streams, a constant (s, c) store)."""
    fields = dict(kind="dot", scheme="kahan", compute_dtype=torch.float32,
                  adds=4.0, muls=1.0,
                  load_bytes_per_elem={8192: 8.0, 16384: 8.0},
                  store_bytes={8192: 65536, 16384: 65536})
    fields.update(overrides)
    return costmodel.CostArtifact(**fields)


@pytest.fixture
def scratch_scheme():
    """Registers schemes for one test; they and their cost cells are torn
    down after it."""
    minted = []

    def _register(scheme):
        schemes.register(scheme)
        minted.append(scheme.name)
        return scheme

    yield _register
    for name in minted:
        schemes.unregister(name)
    costmodel.register_cost_targets()


@pytest.fixture(scope="module")
def port_costs():
    """Every built-in cost cell of the port, built once."""
    costmodel.register_cost_targets()
    return {tid: targets.get(tid).build() for tid in targets.names()
            if tid.startswith("cost.")}


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def test_weighted_op_counts_weights_by_elements():
    a, b = torch.ones(4, 8), torch.ones(4, 8)
    log, _ = trace.op_log(lambda a, b: K.sub(K.mul(K.add(a, b), a), b), a, b)
    assert costmodel.weighted_op_counts(log) == (64.0, 32.0, 0)


def test_weighted_op_counts_fma_ints_and_matrix_ops():
    a = torch.ones(4, 4)
    i = torch.ones(3, dtype=torch.int64)
    log, _ = trace.op_log(
        lambda a, i: (K.fma(a, a, a), i + 1, torch.mm(a, a)), a, i)
    adds, muls, matrix = costmodel.weighted_op_counts(log)
    assert (adds, muls, matrix) == (16.0, 16.0, 1)  # the fma: one of each


def test_probe_mix_counts_the_static_mix_over_the_fold_period():
    """pairwise folds c += s once in 32 steps: its sum path's static mix
    is 2 adds, as in the device code; step 0 alone shows 1."""
    assert costmodel.probe_mix("pairwise", "sum")[:2] == (2.0, 0.0)
    assert costmodel.probe_mix("kahan", "dot")[:2] == (4.0, 1.0)
    assert costmodel.probe_mix("dot2", "dot")[:2] == (18.0, 7.0)
    assert costmodel.probe_mix("naive", "dot", "bfloat16")[:2] == (1.0, 1.0)


def test_counting_scheme_marks_each_fold():
    sch = costmodel.counting(schemes.get("kahan"))
    s = torch.zeros(5)
    with trace.record() as log:
        sch.update(s, s, torch.ones(5), 7)
    steps = costmodel.per_step_counts(log)
    assert steps == {7: (20.0, 0.0, 5)}


# ---------------------------------------------------------------------------
# cost-instruction-mix
# ---------------------------------------------------------------------------

def test_instruction_mix_fires_on_lying_scheme(scratch_scheme):
    scratch_scheme(schemes.CompensationScheme(
        name="liar", update=schemes.KAHAN.update,
        mul_update=schemes.KAHAN.mul_update,
        instruction_mix=schemes.InstructionMix(adds=1, muls=1),
        error_bound=schemes.KAHAN.error_bound))
    report = costmodel.audit(target_ids=["cost.dot.liar"],
                             rule_ids=["cost-instruction-mix"])
    assert [v.rule for v in report.violations] == ["cost-instruction-mix"]
    msg = report.violations[0].message
    assert "4 adds + 1 muls" in msg and "1 + 1" in msg


def test_instruction_mix_verifies_honest_runtime_scheme(scratch_scheme):
    scratch_scheme(schemes.CompensationScheme(
        name="honest", update=schemes.NAIVE.update,
        mul_update=schemes.NAIVE.mul_update,
        instruction_mix=schemes.InstructionMix(adds=1, muls=1),
        error_bound=schemes.NAIVE.error_bound))
    report = costmodel.audit(target_ids=[
        "cost.dot.honest", "cost.asum.honest", "cost.matmul.honest",
        "cost.flash.honest"])
    assert report.violations == [], [v.format() for v in report.violations]
    assert report.files == 4


def test_instruction_mix_fires_on_a_matrix_product_in_a_fold():
    art = _kahan_dot_artifact(matrix_calls=1)
    found = _fired("cost-instruction-mix", ("cost-dot",), art)
    assert found and "matrix-product" in found[0].message


def test_instruction_mix_fires_on_a_fold_with_muls():
    art = _kahan_dot_artifact(kind="matmul", muls=1.0)
    found = _fired("cost-instruction-mix", ("cost-matmul",), art)
    assert found and "4 + 0" in found[0].message


# ---------------------------------------------------------------------------
# cost-memory-traffic
# ---------------------------------------------------------------------------

def test_memory_traffic_fires_on_mismatched_dtype_bytes():
    art = _kahan_dot_artifact(compute_dtype=torch.bfloat16)
    found = _fired("cost-memory-traffic", ("cost-dot",), art)
    assert len(found) == 2
    assert "bfloat16" in found[0].message and "predicts 4" in found[0].message


def test_memory_traffic_fires_on_n_dependent_store():
    art = _kahan_dot_artifact(store_bytes={8192: 65536, 16384: 131072})
    found = _fired("cost-memory-traffic", ("cost-dot",), art)
    assert found and "n-independent" in found[0].message


def test_recorded_traffic_reads_the_kernel_entry():
    loads, stores = costmodel.recorded_traffic("asum", 8192, torch.float64)
    assert (loads, stores) == (8192 * 8, 2 * 64 * 128 * 8)


# ---------------------------------------------------------------------------
# cost-compensation-ratio and cost-ecm-tables-derived
# ---------------------------------------------------------------------------

def test_compensation_ratio_fires_past_the_hide_point():
    """50 flops an element is past the H100's hide-point at U = 8 (the
    issue term passes the bytes near 42)."""
    art = _kahan_dot_artifact(adds=45.0, muls=5.0)
    found = _fired("cost-compensation-ratio", ("cost-dot",), art)
    assert found and "issue-bound" in found[0].message


def test_compensation_is_free_for_every_builtin_on_the_h100():
    """The paper's claim on this card: every built-in's counted dot mix,
    dot2's 25 raw flops included, hides behind the bytes at U = 8 — so
    the reference's dot2 exemptions (compute-bound on v5e) do not apply
    here and the port registers none."""
    report = costmodel.audit(
        target_ids=[f"cost.dot.{n}" for n in BUILTINS])
    assert report.violations == [], [v.format() for v in report.violations]
    assert report.exemptions == []


def test_ecm_tables_fires_on_drifted_mix():
    art = _kahan_dot_artifact(adds=10.0, muls=2.0)
    found = _fired("cost-ecm-tables-derived", ("cost-dot",), art)
    assert found and "models 5 flops/elem" in found[0].message
    assert "executes 12" in found[0].message


# ---------------------------------------------------------------------------
# the scheme registry's mix validation (the reference's satellite fix)
# ---------------------------------------------------------------------------

def test_register_rejects_malformed_mixes():
    with pytest.raises(TypeError, match="adds.*muls.*traced_adds"):
        schemes.CompensationScheme(
            name="badmix", update=schemes.NAIVE.update,
            instruction_mix="4 adds, 1 mul",
            error_bound=schemes.NAIVE.error_bound)
    with pytest.raises(ValueError, match="unknown=\\['flops'\\]"):
        schemes.CompensationScheme(
            name="badmix", update=schemes.NAIVE.update,
            instruction_mix={"adds": 1, "muls": 1, "flops": 2},
            error_bound=schemes.NAIVE.error_bound)
    with pytest.raises(ValueError, match="non-negative int"):
        schemes.CompensationScheme(
            name="badmix", update=schemes.NAIVE.update,
            instruction_mix=schemes.InstructionMix(adds=-1, muls=1),
            error_bound=schemes.NAIVE.error_bound)


def test_register_revalidates_post_construction_edits():
    sch = schemes.CompensationScheme(
        name="mutated", update=schemes.NAIVE.update,
        instruction_mix=schemes.InstructionMix(adds=1, muls=1),
        error_bound=schemes.NAIVE.error_bound)
    object.__setattr__(sch, "instruction_mix", {"adds": 1})
    with pytest.raises(ValueError, match="missing=\\['muls'\\]"):
        schemes.register(sch)


# ---------------------------------------------------------------------------
# the SASS level, on synthetic disassembly
# ---------------------------------------------------------------------------

_SASS = """\
\tcode for sm_90a
\t\tFunction : probe_dot_kahan_f32
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   FFMA.FTZ R0, R2, R3, R4 ;   /* 0x0 */
        /*0020*/                   FADD.FTZ R5, R6, R0 ;   /* 0x0 */
        /*0030*/              @!P0 FADD.FTZ R7, R5, -R6 ;   /* 0x0 */
        /*0040*/                   FADD.FTZ R8, R0, -R7 ;   /* 0x0 */
        /*0050*/                   STG.E desc[UR4][R2.64], R5 ;   /* 0x0 */
        /*0060*/                   EXIT ;   /* 0x0 */
\t\tFunction : _Z14kahan_sum_gridILi1EfEvPKT0_
        /*0000*/                   FFMA R0, R2, R3, R4 ;   /* 0x0 */
        /*0010*/                   HMMA.16816.F32 R4, R8, R12, R4 ;
        /*0020*/                   HFMA2.MMA R5, -RZ, RZ, 0, 1.875 ;
        /*0030*/                   HFMA2.BF16_V2 R6, -RZ.H0_H0, RZ.H0_H0, -R1.H0_H0 ;
"""


def test_opcode_counts_parse_cuobjdump_text():
    funcs = sass_analysis.opcode_counts(_SASS)
    assert set(funcs) == {"probe_dot_kahan_f32",
                          "_Z14kahan_sum_gridILi1EfEvPKT0_"}
    assert funcs["probe_dot_kahan_f32"] == {
        "LDC": 1, "FFMA": 1, "FADD": 3, "STG": 1, "EXIT": 1}
    assert sass_analysis.float_mix(funcs["probe_dot_kahan_f32"]) == (4, 1)
    # nvcc's zero-multiplicand HFMA2 (a constant, a bf16 negation) moves
    sum_ops = funcs["_Z14kahan_sum_gridILi1EfEvPKT0_"]
    assert sum_ops[sass_analysis.MOV_IDIOM] == 2 and "HFMA2" not in sum_ops
    assert sass_analysis.kernel_of("_Z14kahan_sum_gridILi1EfEvPKT0_") == \
        "kahan_sum_grid"


def _probe(**kw):
    fields = dict(kind="probe", scheme="kahan", dtype="f32", path="dot",
                  adds=4, muls=1, opcodes={"FFMA": 1, "FADD": 3},
                  baseline=1)
    fields.update(kw)
    return costmodel.SassArtifact(**fields)


@pytest.fixture
def sass_rules():
    costmodel.register_sass()
    yield
    costmodel.unregister_sass()


def test_sass_mix_fires_on_a_probe_off_its_declaration(sass_rules):
    assert _fired("cost-instruction-mix", ("sass-probe",), _probe()) == []
    found = _fired("cost-instruction-mix", ("sass-probe",),
                   _probe(adds=3, opcodes={"FFMA": 1, "FADD": 2}))
    assert found and "3 adds + 1 muls" in found[0].message


def test_sass_census_gates(sass_rules):
    census = costmodel.SassArtifact(kind="census", functions=
                                    sass_analysis.opcode_counts(_SASS))
    msgs = [v.message for v in _fired("cost-instruction-mix",
                                      ("sass-census",), census)]
    assert any("tensor-core" in m for m in msgs)
    assert any("fused multiply-add" in m for m in msgs)
    clean = costmodel.SassArtifact(kind="census", functions={
        "_Z14kahan_dot_gridILi1EfEv": {"FFMA": 4, "FADD": 9},
        "_Z14kahan_sum_gridILi1EfEv": {"FADD": 9}})
    assert _fired("cost-instruction-mix", ("sass-census",), clean) == []


def test_sass_hidden_copies_and_folded_adds_fire(sass_rules):
    found = _fired("cost-no-hidden-copies", ("sass-f32",),
                   _probe(opcodes={"F2F": 1, "FADD": 3, "FFMA": 1}))
    assert found and "F2F" in found[0].message
    found = _fired("trace-barrier-survives-fusion", ("sass-probe",),
                   _probe(adds=2, baseline=1))
    assert found and "folded" in found[0].message
    assert _fired("trace-barrier-survives-fusion", ("sass-probe",),
                  _probe()) == []


def test_sass_without_nvcc_is_a_build_error_finding(monkeypatch, capsys,
                                                    tmp_path):
    """On a machine without nvcc (this one), --sass is a finding and exit
    1, never a silent skip."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    try:
        assert cli_main(["--cost", "--sass", "--strict", "--target",
                         "sass.probe.dot.kahan.f32"]) == 1
        assert "cost-build-error" in capsys.readouterr().out
        report = costmodel.audit(target_ids=["sass.census"])
        (v,) = report.violations
        assert v.rule == "cost-build-error" and "nvcc" in v.message
    finally:
        costmodel.unregister_sass()


def test_sass_registers_a_probe_per_builtin_dtype_and_path(sass_rules):
    ids = costmodel.register_cost_targets()
    probes = [t for t in ids if t.startswith("sass.probe.")]
    assert len(probes) == len(BUILTINS) * 3 * 2
    assert "sass.census" in ids
    assert set(costmodel.names()) >= {"cost-no-hidden-copies",
                                      "trace-barrier-survives-fusion"}


# ---------------------------------------------------------------------------
# registry + audit
# ---------------------------------------------------------------------------

def test_cost_rule_registry_roundtrip():
    rule = costmodel.CostRule(
        id="cost-toy", tags=("cost-dot",), checker=lambda t, a: iter(()),
        fix_hint="n/a", doc="toy")
    costmodel.register(rule)
    try:
        with pytest.raises(ValueError, match="already registered"):
            costmodel.register(rule)
        with pytest.raises(ValueError, match="unknown cost rule"):
            costmodel.get("cost-nope")
    finally:
        costmodel.unregister("cost-toy")
    assert "cost-toy" not in costmodel.names()


def test_register_cost_targets_idempotent_and_prunes(scratch_scheme):
    scratch_scheme(schemes.CompensationScheme(
        name="ephemeral", update=schemes.NAIVE.update,
        instruction_mix=schemes.InstructionMix(adds=1, muls=1),
        error_bound=schemes.NAIVE.error_bound))
    ids = costmodel.register_cost_targets()
    assert "cost.dot.ephemeral" in ids
    assert ids == costmodel.register_cost_targets()
    schemes.unregister("ephemeral")
    assert "cost.dot.ephemeral" not in costmodel.register_cost_targets()
    assert "cost.dot.ephemeral" not in targets.names()


def test_build_failure_becomes_finding_not_crash():
    def boom():
        raise RuntimeError("no count for you")

    targets.register(_toy_target(("cost", "cost-dot"), build=boom))
    try:
        (v,) = costmodel.audit(target_ids=["toy.cost.fixture"]).violations
        assert v.rule == "cost-build-error" and "no count" in v.message
    finally:
        targets.unregister("toy.cost.fixture")


def test_stale_cost_exemption_surfaces_as_unused():
    targets.register(_toy_target(
        ("cost", "cost-dot"), build=_kahan_dot_artifact,
        exempt={"cost-compensation-ratio": "does not fire"}))
    try:
        report = costmodel.audit(target_ids=["toy.cost.fixture"])
        assert report.violations == []
        (p,) = report.exemptions
        assert p.rule == "cost-compensation-ratio" and p.used is False
    finally:
        targets.unregister("toy.cost.fixture")


def test_cost_report_shares_json_schema():
    report = costmodel.audit(target_ids=["cost.dot.kahan"])
    payload = json.loads(render_json(
        report, rules=costmodel.registered().values()))
    assert set(payload) == {"files", "violations", "exemptions",
                            "pragma_errors", "rules", "budget"}
    assert {r["id"] for r in payload["rules"]} == set(costmodel.names())


def test_cli_cost_exit_codes(capsys):
    assert cli_main(["--cost", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "cost-instruction-mix" in out and "cost.dot.kahan" in out
    assert cli_main(["--cost", "--target", "cost.dot.kahan",
                     "--rule", "cost-instruction-mix"]) == 0
    assert cli_main(["--cost", "--target", "no.such.target"]) == 2
    assert cli_main(["--cost", "--rule", "no-such-rule"]) == 2
    assert cli_main(["--cost", "--rule", "cost-no-hidden-copies"]) == 2
    assert cli_main(["--cost", "--trace"]) == 2
    assert cli_main(["--cost", "src/repro_torch"]) == 2


def test_port_cost_self_audit_clean():
    """The port's folds and traffic are what the schemes declare: zero
    violations over every (kind x scheme) cell and the bf16 cell, no
    exemption (``python -m repro_torch.analysis --cost --strict``)."""
    assert cli_main(["--cost", "--strict"]) == 0
    report = costmodel.audit()
    assert report.violations == [], [v.format() for v in report.violations]
    assert report.files == 4 * len(BUILTINS) + 1
    assert report.exemptions == []


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_costs():
    """The reference's cost cells, traced once (jax at float32; the
    float64 cells under x64)."""
    import jax

    from repro.analysis import costmodel as jcost
    from repro.analysis import targets as jtargets

    jcost.register_cost_targets()
    out = {tid: jtargets.get(tid).build() for tid in jtargets.names()
           if tid.startswith("cost.")}
    with jax.enable_x64(True):
        for kind in ("dot", "asum"):
            out[f"cost.{kind}.kahan.f64"] = jcost._reduction_cost_build(
                kind, "kahan", compute_dtype="float64")()
    return out


def test_cost_rule_ids_equal_the_references():
    from repro.analysis import costmodel as jcost

    assert set(costmodel.names()) == \
        set(jcost.names()) - {"cost-no-hidden-copies"}
    costmodel.register_sass()
    try:
        assert set(costmodel.names()) == set(jcost.names()) | {
            "trace-barrier-survives-fusion"}
    finally:
        costmodel.unregister_sass()


@pytest.mark.parametrize("scheme", BUILTINS)
@pytest.mark.parametrize("kind", ("dot", "asum", "matmul"))
def test_counted_mix_equals_the_references(kind, scheme, port_costs,
                                           ref_costs):
    port = port_costs[f"cost.{kind}.{scheme}"]
    ref = ref_costs[f"cost.{kind}.{scheme}"]
    assert (port.adds, port.muls) == (ref.adds, ref.muls)


@pytest.mark.parametrize("scheme", BUILTINS)
def test_flash_fold_delta_equals_the_references(scheme, port_costs,
                                                ref_costs):
    """The reference counts its whole flash block body and gates the
    difference to naive's; the port counts the fold sites: the same
    difference, and no muls added by the folds."""
    port, naive = port_costs[f"cost.flash.{scheme}"], \
        port_costs["cost.flash.naive"]
    ref = ref_costs[f"cost.flash.{scheme}"]
    assert port.fold_elems == ref.fold_elems
    assert (port.adds - naive.adds) * port.fold_elems == \
        ref.adds - ref.baseline_adds
    assert port.muls == naive.muls == 0.0
    assert ref.muls == ref.baseline_muls


@pytest.mark.parametrize("cell,dtype", [
    ("cost.dot.kahan", torch.float32), ("cost.asum.kahan", torch.float32),
    ("cost.dot.kahan.bf16", torch.bfloat16),
    ("cost.dot.kahan.f64", torch.float64),
    ("cost.asum.kahan.f64", torch.float64)])
def test_bytes_per_element_equal_the_references(cell, dtype, ref_costs):
    kind = cell.split(".")[1]
    ref = ref_costs[cell]
    for n, want in ref.load_bytes_per_elem.items():
        loads, stores = costmodel.recorded_traffic(kind, n, dtype)
        assert loads / n == want
        assert stores == ref.store_bytes[n]


def test_reference_cells_cover_the_ports(port_costs, ref_costs):
    assert set(port_costs) == {t for t in ref_costs
                               if not t.endswith(".f64")}


def test_dataclass_fields_mirror_the_references():
    from repro.analysis import costmodel as jcost

    ref = {f.name for f in dataclasses.fields(jcost.CostArtifact)}
    port = {f.name for f in dataclasses.fields(costmodel.CostArtifact)}
    # the port counts folds, not a whole body: no baseline, no HLO; it
    # reports the in-block chain and names matrix products apart
    assert ref - port == {"baseline_adds", "baseline_muls", "hlo",
                          "mxu_calls"}
    assert port - ref == {"chain_adds", "chain_muls", "matrix_calls"}

"""The port's machine model (``repro_torch.core.ecm``) against the JAX
package's (``repro.core.ecm``), and its H100 half's invariants.

Parity tiers:

* tier 1 (equal, field for field): the x86 half (machines, registry
  kernels, ``ecm_x86`` results, ``multicore_scaling``) for SNB/IVB/HSW/BDW
  x every registered scheme x scalar/SSE/AVX x 4 and 8 bytes; the named
  x86 constants; ``expected_cost`` for every built-in; sections (a) and
  (b) of ``examples/reproduce_paper_torch.py`` against
  ``examples/reproduce_paper.py``'s output, line for line.
* the H100 half has no reference (the reference's second half models a
  TPU): its invariants at stated numbers, its CTA and SM columns equal to
  ``kahan_dot.reduce_plan``'s, and ``RooflineTerms`` at hand-computed
  values (float tolerance 1e-12, relative).
"""

import contextlib
import dataclasses
import io
import math
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ecm as jecm
from repro_torch.core import ecm
from repro_torch.kernels import kahan_dot
from repro_torch.kernels import schemes as tschemes

ROOT = Path(__file__).resolve().parents[1]
BUILTINS = ("naive", "kahan", "pairwise", "dot2")
PAPER_N = 1 << 27


def _fields(x):
    return dataclasses.asdict(x)


# ---------------------------------------------------------------------------
# Part 1: the paper's x86 model, equal to the reference
# ---------------------------------------------------------------------------

def test_paper_machines_equal_the_reference():
    assert set(ecm.PAPER_MACHINES) == set(jecm.PAPER_MACHINES)
    for name, m in ecm.PAPER_MACHINES.items():
        assert _fields(m) == _fields(jecm.PAPER_MACHINES[name])
        assert m.t_l3mem_cy_per_cl() == \
            jecm.PAPER_MACHINES[name].t_l3mem_cy_per_cl()


@pytest.mark.parametrize("elem_bytes", [4, 8])
@pytest.mark.parametrize("simd", ["scalar", "sse", "avx"])
@pytest.mark.parametrize("machine", ["SNB", "IVB", "HSW", "BDW"])
def test_ecm_x86_equals_the_reference(machine, simd, elem_bytes):
    kerns = ecm.registry_dot_kernels(simd=simd, elem_bytes=elem_bytes)
    jkerns = jecm.registry_dot_kernels(simd=simd, elem_bytes=elem_bytes)
    assert set(kerns) == set(jkerns) >= set(BUILTINS)
    for name, kern in kerns.items():
        assert _fields(kern) == _fields(jkerns[name])
        got = ecm.ecm_x86(ecm.PAPER_MACHINES[machine], kern)
        want = jecm.ecm_x86(jecm.PAPER_MACHINES[machine], jkerns[name])
        assert _fields(got) == _fields(want), (machine, name)
        assert got.shorthand() == want.shorthand()
        assert got.pred_shorthand() == want.pred_shorthand()


@pytest.mark.parametrize("machine", ["SNB", "IVB", "HSW", "BDW"])
def test_multicore_scaling_equals_the_reference(machine):
    m, jm = ecm.PAPER_MACHINES[machine], jecm.PAPER_MACHINES[machine]
    for name in BUILTINS:
        kern = ecm.dot_kernel_for_scheme(name)
        jkern = jecm.dot_kernel_for_scheme(name)
        got = [ecm.multicore_scaling(m, kern, n)
               for n in range(1, m.cores + 1)]
        want = [jecm.multicore_scaling(jm, jkern, n)
                for n in range(1, m.cores + 1)]
        assert got == want, (machine, name)
        assert got == sorted(got)   # rises, then saturates


@pytest.mark.parametrize("name", ["NAIVE_SP", "KAHAN_SCALAR_SP",
                                  "KAHAN_SSE_SP", "KAHAN_AVX_SP",
                                  "KAHAN_SCALAR_DP", "KAHAN_AVX_DP"])
def test_named_x86_kernels_equal_the_reference(name):
    assert _fields(getattr(ecm, name)) == _fields(getattr(jecm, name))


def test_paper_numbers_reproduced():
    """The paper's §3 Eq. 2 on IvyBridge, as the reference pins them."""
    r = ecm.ecm_x86(ecm.IVB, ecm.NAIVE_SP)
    assert r.perf_gups == (8.80, 4.40, 2.93, 1.68) and r.n_s == 4
    assert ecm.ecm_x86(ecm.IVB, ecm.KAHAN_SCALAR_SP).n_s == 11


@pytest.mark.parametrize("name", BUILTINS)
def test_expected_cost_equals_the_reference(name):
    for kw, jkw in (({}, {}),
                    (dict(compute_dtype=torch.float64),
                     dict(compute_dtype="float64")),
                    (dict(compute_dtype="bfloat16", streams=1),
                     dict(compute_dtype="bfloat16", streams=1)),
                    (dict(elem_bytes=8), dict(elem_bytes=8))):
        got = ecm.expected_cost(name, **kw)
        want = jecm.expected_cost(name, **jkw)
        assert _fields(got) == _fields(want), (name, kw)
        assert got.traced_flops == want.traced_flops
        assert got.load_bytes_per_elem == want.load_bytes_per_elem


@pytest.mark.parametrize("dtype,nbytes", [
    (torch.float32, 4), (torch.float64, 8), (torch.bfloat16, 2),
    (np.float32, 4), (np.dtype("float64"), 8), ("bfloat16", 2),
    ("float32", 4)])
def test_elem_bytes_for_torch_numpy_and_names(dtype, nbytes):
    assert ecm.elem_bytes_for_dtype(dtype) == nbytes


def test_elem_bytes_refuses_other_dtypes():
    for bad in (torch.int32, "float16", np.int8):
        with pytest.raises(ValueError, match="compute_dtype"):
            ecm.elem_bytes_for_dtype(bad)


def test_reproduce_paper_sections_a_and_b_equal_the_reference():
    """Sections (a) and (b) of the port's example print the reference
    example's lines, line for line; (c) is the H100's table."""
    def run(script):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "examples" / script),
                           run_name="__main__")
        lines = out.getvalue().splitlines()
        cut = next(i for i, ln in enumerate(lines) if ln.startswith("(c)"))
        return lines[:cut], lines[cut:]

    ours, table = run("reproduce_paper_torch.py")
    theirs, _ = run("reproduce_paper.py")
    assert ours == theirs
    rows = [ln for ln in table if ln.split()[:1] in (["dot"], ["sum"])]
    assert len(rows) == 2 * len(BUILTINS) * len(ecm.UNROLLS)


# ---------------------------------------------------------------------------
# Part 2: the H100 half
# ---------------------------------------------------------------------------

def test_h100_published_constants():
    m = ecm.H100
    assert (m.sms, m.fp32_lanes_per_sm, m.hbm_gbs, m.fp32_tflops,
            m.bf16_tflops, m.nvlink_gbs, m.add_latency_cy) == (
        132, 128, 3350.0, 67.0, 989.0, 900.0, 4.0)
    assert m.load_gbs < m.hbm_gbs        # load-only b_S below the peak


def test_kahan_dot_free_at_u8():
    """At the paper's n = 2^27 and U = 8 the kahan dot is bandwidth-bound
    and predicted equal to naive: the paper's 'compensation is free'."""
    kahan = ecm.ecm_gpu(ecm.H100, ecm.KAHAN_DOT_H100, PAPER_N, 8)
    naive = ecm.ecm_gpu(ecm.H100, ecm.NAIVE_DOT_H100, PAPER_N, 8)
    assert kahan.bound == naive.bound == "hbm"
    assert kahan.pred_ms == naive.pred_ms == kahan.t_hbm_ms
    assert kahan.t_chain_ms < kahan.t_hbm_ms


def test_kahan_sum_chain_at_stated_numbers():
    """4 dependent adds of 4 cycles a step at 1980 MHz: 16384 steps of a
    chain at U = 8 take 0.1324 ms."""
    m = dataclasses.replace(ecm.H100, clock_mhz=1980.0, add_latency_cy=4.0)
    r = ecm.ecm_gpu(m, ecm.KAHAN_SUM_H100, PAPER_N, 8)
    assert ecm.KAHAN_SUM_H100.dep_ops == 4 and r.steps == 16384
    assert math.isclose(r.t_chain_ms, 16384 * 16 / 1.98e6, rel_tol=1e-12)
    assert round(r.t_chain_ms, 4) == 0.1324
    naive = ecm.ecm_gpu(m, ecm.NAIVE_SUM_H100, PAPER_N, 8)
    assert naive.t_chain_ms == r.t_chain_ms / 4


def test_u_s_monotone_in_the_chain_length():
    """A longer chain never saturates the bytes at a smaller U."""
    for streams in (1, 2):
        seen = []
        for dep in range(1, 17):
            kern = ecm.GPUKernel("k", streams=streams, elem_bytes=4,
                                 flops=dep, dep_ops=dep)
            u_s = ecm.ecm_gpu(ecm.H100, kern, PAPER_N, 8).u_s
            seen.append(math.inf if u_s is None else u_s)
        assert seen == sorted(seen), (streams, seen)
        assert seen[0] <= seen[3] < math.inf


@pytest.mark.parametrize("unroll", ecm.UNROLLS)
@pytest.mark.parametrize("op", ["dot", "sum"])
def test_ctas_and_sms_are_the_plans(op, unroll):
    """The CTA and SM columns are ``reduce_plan``'s (32, 64, then 128 CTAs
    for one row of 2^27), and the terms follow their definitions."""
    m = ecm.H100
    streams = 2 if op == "dot" else 1
    cells = 1024 * unroll
    chains = kahan_dot.reduce_plan(1, cells, PAPER_N // cells, 4, streams,
                                   m.sms)[0]
    for name in BUILTINS:
        r = ecm.ecm_gpu_for_scheme(m, name, PAPER_N, unroll, op=op)
        assert (r.chains, r.ctas) == (chains, cells // chains)
        assert r.sms_used == min(r.ctas, m.sms) == min(32 * unroll, 128)
        assert r.pred_ms == max(r.t_hbm_ms, r.t_chain_ms, r.t_issue_ms,
                                r.t_sm_ms)
        assert getattr(r, f"t_{r.bound}_ms") == r.pred_ms
        nbytes = (PAPER_N * streams + 2 * cells) * 4
        assert math.isclose(r.bytes_bound_ms, nbytes / 3.35e9,
                            rel_tol=1e-12)
        assert math.isclose(r.t_hbm_ms, nbytes / (m.load_gbs * 1e6),
                            rel_tol=1e-12)


def test_batched_rows_fill_more_sms():
    """Eight rows at U = 8 are 1024 CTAs of 128 chains: 8 on the busiest
    of 132 SMs, whose lanes the issue term divides by."""
    r = ecm.ecm_gpu(ecm.H100, ecm.KAHAN_DOT_H100, 1 << 24, 8, batch=8)
    assert (r.chains, r.ctas, r.sms_used, r.sm_chains) == (128, 64 * 8,
                                                          132, 4 * 128)
    assert math.isclose(r.t_issue_ms, 4 * r.steps * 5
                        / (ecm.H100.clock_mhz * 1e3), rel_tol=1e-12)


def test_chain_ops_follow_the_device_functions():
    assert set(ecm.CHAIN_OPS) == {tschemes.NAIVE_ID, tschemes.KAHAN_ID,
                                  tschemes.PAIRWISE_ID, tschemes.DOT2_ID}
    deps = {n: ecm.gpu_kernel_for_scheme(n).dep_ops for n in BUILTINS}
    assert deps == {"naive": 1, "kahan": 4, "pairwise": 1, "dot2": 1}
    flops = {n: (ecm.gpu_kernel_for_scheme(n).flops,
                 ecm.gpu_kernel_for_scheme(n, op="sum").flops)
             for n in BUILTINS}
    assert flops == {"naive": (2, 1), "kahan": (5, 4), "pairwise": (3, 2),
                     "dot2": (25, 7)}


def test_runtime_scheme_falls_back_to_a_sequential_chain():
    mine = tschemes.CompensationScheme(
        name="test_torch_ecm_mine", update=tschemes.NAIVE.update,
        instruction_mix=tschemes.InstructionMix(adds=3, muls=2),
        error_bound=tschemes.NAIVE.error_bound)
    tschemes.register(mine)
    try:
        kern = ecm.registry_gpu_kernels()["test_torch_ecm_mine"]
        assert (kern.flops, kern.dep_ops) == (5, 5)
        assert ecm.gpu_kernel_for_scheme(mine, op="sum").dep_ops == 3
        assert "test_torch_ecm_mine" in ecm.registry_dot_kernels()
    finally:
        tschemes.unregister("test_torch_ecm_mine")
    with pytest.raises(ValueError, match="op must be"):
        ecm.gpu_kernel_for_scheme("kahan", op="matmul")


def test_sm_rate_fit_only_where_the_row_shows_it():
    kern = ecm.NAIVE_DOT_H100
    bare = dataclasses.replace(ecm.H100, sm_load_gbs=None)
    r = ecm.ecm_gpu(bare, kern, PAPER_N, 1)
    assert ecm.fit_sm_load_gbs(bare, kern, PAPER_N, 1, r.pred_ms) is None
    edge = (1 + ecm.SM_LIMIT_MARGIN) * r.pred_ms
    assert ecm.fit_sm_load_gbs(bare, kern, PAPER_N, 1, edge) is None
    assert ecm.fit_sm_load_gbs(bare, kern, PAPER_N, 1, 1.01 * edge) > 0
    rate = ecm.fit_sm_load_gbs(bare, kern, PAPER_N, 1, 4 * r.pred_ms)
    fitted = ecm.ecm_gpu(dataclasses.replace(bare, sm_load_gbs=rate), kern,
                         PAPER_N, 1)
    assert fitted.bound == "sm"
    assert math.isclose(fitted.pred_ms, 4 * r.pred_ms, rel_tol=1e-12)


def test_predicted_us_and_model_error():
    r = ecm.ecm_gpu_for_scheme(ecm.H100, "kahan", PAPER_N, 4, op="sum")
    assert ecm.predicted_us_per_call("kahan", PAPER_N, unroll=4,
                                     op="sum") == r.pred_ms * 1e3
    assert ecm.model_relative_error(90.0, 100.0) == 0.1
    assert ecm.model_relative_error(1.0, 0.0) == math.inf
    assert ecm.chain_scaling(ecm.H100, ecm.KAHAN_SUM_H100, PAPER_N, 1) < \
        ecm.chain_scaling(ecm.H100, ecm.KAHAN_SUM_H100, PAPER_N, 8) <= \
        ecm.H100.load_gbs / 4


def test_lazy_constants_and_unknown_names():
    assert ecm.DOT2_H100 == ecm.gpu_kernel_for_scheme("dot2", name="dot2")
    with pytest.raises(AttributeError):
        ecm.KAHAN_DOT_TPU  # noqa: B018  (the TPU half has no counterpart)


# ---------------------------------------------------------------------------
# Part 3: roofline terms on the H100
# ---------------------------------------------------------------------------

def test_roofline_terms_on_the_h100():
    r = ecm.RooflineTerms(flops=2 * 989e12, hbm_bytes=3.35e12,
                          collective_bytes=4 * 900e9, chips=2)
    assert math.isclose(r.compute_s, 1.0, rel_tol=1e-12)
    assert math.isclose(r.memory_s, 0.5, rel_tol=1e-12)
    assert math.isclose(r.collective_s, 2.0, rel_tol=1e-12)
    assert r.dominant == "collective" and r.step_time_s == r.collective_s
    assert math.isclose(r.roofline_fraction(989e12), 0.25, rel_tol=1e-12)
    zero = ecm.RooflineTerms(0.0, 0.0, 0.0, 1)
    assert zero.roofline_fraction(1.0) == 0.0 and zero.machine is ecm.H100


def test_import_needs_no_torch():
    """``import repro_torch.core.ecm`` reaches the registry only when a
    function asks for it."""
    import subprocess
    import sys

    code = ("import sys; import repro_torch.core.ecm as e; "
            "print('torch' in sys.modules, e.H100.sms)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "132"]

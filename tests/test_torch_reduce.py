"""The plan of the port's reduction kernels (``kahan_dot_grid`` and
``kahan_sum_grid``, B1-B4), on the CPU: ``kahan_dot.reduce_plan`` cuts a
launch into CTAs and sizes its shared-memory load ring on the host. The
plan changes no bit (the card tests in ``tests/test_torch_cuda.py`` hold
every plan's grids against the plain versions); these tests pin what the
kernel's C entry checks and what the plan promises the card.
"""

import itertools

import pytest
import torch

from repro_torch.kernels import kahan_dot, kahan_sum

plan = kahan_dot.reduce_plan
SMS = 132
BATCHES = (1, 3, 4, 8, 64, 65535)
STEPS = (1, 7, 1027, 16384, 1 << 20)


def _cells(unroll):
    return kahan_dot.SUBLANES * unroll * kahan_dot.LANES


@pytest.mark.parametrize("unroll", [1, 2, 4, 8, 16])
def test_plan_chains_divide_cells(unroll):
    """Every CTA owns whole chains of one batch row: its width is one of
    the kernel's and divides the row's cells, for every batch, step count,
    dtype and operand count."""
    cells = _cells(unroll)
    for batch, steps, itemsize, operands in itertools.product(
            BATCHES, STEPS, (2, 4, 8), (1, 2)):
        chains, depth, stages, _ = plan(batch, cells, steps, itemsize,
                                        operands, SMS)
        assert chains in kahan_dot.CTA_CHAINS
        assert cells % chains == 0
        assert depth in kahan_dot.STAGE_DEPTHS and stages >= 1


@pytest.mark.parametrize("unroll", [1, 2, 4, 8, 16])
def test_plan_fills_the_sms(unroll):
    """The busiest SM holds the fewest chains that warp-wide CTAs allow
    (all CTAs resident), and the widest CTA that does so is taken: one row
    at U = 8 runs 128 CTAs of 64 chains on 132 SMs, U = 1 32 CTAs of 32
    (all its cells allow), the batched shapes 128-chain CTAs."""
    cells = _cells(unroll)
    for batch in BATCHES:
        chains = plan(batch, cells, 16384, 4, 2, SMS)[0]
        ctas = batch * cells // chains
        floor = 32 * -(-(batch * cells // 32) // SMS)
        assert -(-ctas // SMS) * chains == floor
        wider = [c for c in kahan_dot.CTA_CHAINS if c > chains]
        assert all(-(-(batch * cells // c) // SMS) * c > floor
                   for c in wider)
    assert plan(1, _cells(8), 16384, 4, 2, SMS)[0] == 64
    assert plan(1, _cells(1), 16384, 4, 2, SMS)[0] == 32
    assert plan(1, _cells(16), 16384, 4, 2, SMS)[0] == 128
    assert plan(8, _cells(8), 2048, 4, 2, SMS)[0] == 128
    # fewer SMs, wider CTAs: 64 SMs hold 8192 chains 128 at a time
    assert plan(1, _cells(8), 16384, 4, 2, 64)[0] == 128


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_plan_fits_shared_memory(itemsize):
    """Every plan's shared memory is its layout's and fits the H100's
    232448 bytes a CTA; the rings an SM holds stay within ``RING_BYTES``
    (or two stages), a stage within ``STAGE_BYTES`` (or the shallowest
    depth), and no stage is deeper than the steps round up to."""
    for unroll, batch, steps, operands in itertools.product(
            (1, 2, 4, 8, 16), BATCHES, STEPS, (1, 2)):
        cells = _cells(unroll)
        chains, depth, stages, smem = plan(batch, cells, steps, itemsize,
                                           operands, SMS)
        assert smem == kahan_dot.reduce_smem_bytes(
            chains, depth, stages, itemsize, operands) <= 232448
        per_sm = -(-(batch * cells // chains) // SMS)
        stage = depth * operands * chains * itemsize
        assert stage * stages <= max(kahan_dot.RING_BYTES // per_sm,
                                     2 * stage)
        assert (stage <= kahan_dot.STAGE_BYTES
                or depth == kahan_dot.STAGE_DEPTHS[-1])
        assert depth <= max(8, 2 * steps)


def test_plan_worked_constants():
    """The paper's shapes at U = 8, float32, worked by hand from the
    layout ``stages * (operands * depth * chains * itemsize + 16)``."""
    # dot [2^27]: 64 chains, 1 CTA an SM, 512-byte steps: 16 KB stages of
    # 32 steps in a 64 KB ring
    assert plan(1, 8192, 16384, 4, 2, SMS) == (64, 32, 4, 65600)
    # sum [2^27]: 256-byte steps, 64 a stage
    assert plan(1, 8192, 16384, 4, 1, SMS) == (64, 64, 4, 65600)
    # dot [8, 2^24]: 512 CTAs of 128, 4 an SM: 16 KB rings of 8 KB stages
    assert plan(8, 8192, 2048, 4, 2, SMS) == (128, 8, 2, 16416)
    # sum [8, 2^24]: 512-byte steps, 16 a stage
    assert plan(8, 8192, 2048, 4, 1, SMS) == (128, 16, 2, 16416)
    # the serving telemetry, sum [4, 57344]: 7 steps, one partial stage
    assert plan(4, 8192, 7, 4, 1, SMS) == (128, 8, 1, 4112)
    assert kahan_dot.reduce_smem_bytes(64, 32, 4, 4, 2) == 4 * 16400
    assert kahan_dot.reduce_smem_bytes(128, 8, 4, 8, 2) == 4 * 16400
    assert kahan_dot.reduce_smem_bytes(32, 16, 1, 2, 1) == 1040


@pytest.mark.parametrize("steps", [1, 7])
def test_plan_tiny_step_counts(steps):
    """A row shorter than a stage gets one partial stage, and nothing more
    is allocated than the steps fill."""
    for batch, unroll, itemsize, operands in itertools.product(
            (1, 4), (1, 8), (2, 4, 8), (1, 2)):
        chains, depth, stages, smem = plan(batch, _cells(unroll), steps,
                                           itemsize, operands, SMS)
        assert stages == 1 and depth >= steps
        assert smem == operands * depth * chains * itemsize + 16


def test_plan_is_cached_and_checked():
    """The wrappers ask at every launch: the plan is cached. A shape the
    kernel cannot take raises."""
    plan.cache_clear()
    first = plan(1, 8192, 16384, 4, 2, SMS)
    assert plan(1, 8192, 16384, 4, 2, SMS) is first
    assert plan.cache_info().hits == 1
    assert kahan_sum.reduce_plan is plan
    for bad in ((0, 8192, 1, 4, 2), (1, 8192, 0, 4, 2), (1, 8192, 1, 4, 3),
                (1, 100, 1, 4, 2)):
        with pytest.raises(ValueError):
            plan(*bad, SMS)


def test_copy_path_follows_the_pointers():
    """16-byte copies when every operand starts on 16 bytes; one element a
    copy when any is off (a view at an odd offset), with nothing copied."""
    x = torch.zeros(2 * 8192 + 1)
    a, b = x[:8192], x[8192:2 * 8192]
    assert kahan_dot.copy_path(a) == kahan_dot.copy_path(a, b) == "cp.async"
    assert kahan_dot.copy_path(x[1:]) == "element"
    assert kahan_dot.copy_path(a, x[1:8193]) == "element"
    assert set(kahan_dot.COPY) == {"cp.async", "element"}

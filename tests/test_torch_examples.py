"""The port's examples (``examples/*_torch.py``) on the CPU at smoke
size: the quickstart end to end, its dot and sum lines equal to the
reference example's (tier 1: the kernels' bits and ``gen_dot``'s data are
the reference's); the batched-serving example under the paged layout
and the dense one, the same tokens (tier 2); the training example's
functions at a reduced width, with a checkpoint it resumes from."""

import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import latest_step

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' smoke sizes on one intra-op thread: test files run
    side by side on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(EXAMPLES / script), *args],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


#: a dot line's value and error, or the kahan_sum line, after the label
_DOT = re.compile(r"^  (?:naive|kahan|dot2) +\(.*?\) +(\S+  relerr=\S+)$")
_SUM = re.compile(r"^  kahan_sum +: .*$")


def _bitwise_lines(out):
    lines = out.splitlines()
    return ([m.group(1) for m in map(_DOT.match, lines) if m]
            + [line for line in lines if _SUM.match(line)])


def test_quickstart_runs_and_matches_the_reference_lines():
    port = _run("quickstart_torch.py", "--device", "cpu")
    assert port.returncode == 0, port.stderr[-2000:]
    assert "served: {0: [" in port.stdout and "ECM H100" in port.stdout
    # the reference example prints its dot and sum lines before its
    # third section (which needs an x64 switch its jax may lack)
    ref = _run("quickstart.py")
    want, got = _bitwise_lines(ref.stdout), _bitwise_lines(port.stdout)
    assert len(want) == len(got) == 5, (ref.stdout, ref.stderr[-500:])
    assert got == want
    assert "relerr=2.51e-08" in got[3]            # dot2 recovers all


def test_serve_batched_paged_and_dense_serve_the_same_tokens(capsys):
    serve = _load("serve_batched_torch")
    runs = {}
    for layout in ("paged", "dense"):
        serve.main(["--device", "cpu"] + (["--dense"] if layout == "dense"
                                          else []))
        out = capsys.readouterr().out
        runs[layout] = [line for line in out.splitlines()
                        if line.startswith("request ")]
        if layout == "paged":
            hit = re.search(r"prefix cache: (\d+) prompt tokens", out)
            assert hit and int(hit.group(1)) > 0
    assert len(runs["paged"]) == 5
    assert runs["paged"] == runs["dense"]


def test_train_lm_functions_train_and_resume(tmp_path):
    lm = _load("train_lm_torch")
    cfg = lm.lm_config("olmo-1b", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=4, d_ff=128, vocab_size=256, loss_chunk=16)
    assert lm.lm_config("olmo-1b").param_counts()["total"] > 1e8
    tc = lm.train_config(3, tmp_path)
    assert (tc.warmup, tc.ckpt_every, tc.microbatches) == (30, 50, 2)
    kw = dict(device="cpu", seq_len=32, global_batch=4)
    trainer, losses, ms, peak = lm.train(cfg, tc, **kw)
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    assert trainer.step == 3 and ms > 0 and peak is None
    assert latest_step(str(tmp_path)) == 3          # the last step's save
    resumed, more, _, _ = lm.train(cfg, lm.train_config(4, tmp_path), **kw)
    assert resumed.step == 4 and len(more) == 1
    assert math.isfinite(more[0])

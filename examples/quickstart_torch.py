"""Quickstart of the PyTorch/CUDA port: the paper's kernel as a library
call (``examples/quickstart.py`` over ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card by default (the compensated kernels built from
``src/repro_torch/csrc`` at first use); ``--device cpu`` runs their
plain versions, which give the same bits.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import numerics
from repro_torch.core.kahan import kahan_dot, kahan_sum, naive_dot
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, use_policy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. An ill-conditioned dot product (cond ~ 1e6): naive fp32 loses
    #    digits; the Kahan kernel recovers most; dot2 recovers all.
    a, b, exact, cond = numerics.gen_dot(8192, 1e4, seed=0)
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    print(f"condition number: {cond:.2e}; exact value: {exact:.9e}")
    for name, val in [
        ("naive (sequential)", float(naive_dot(ta, tb))),
        ("kahan (pure torch)", float(kahan_dot(ta, tb))),
        ("kahan (cuda kernel)", float(ops.dot(ta, tb, scheme="kahan"))),
        ("dot2  (cuda kernel)", float(ops.dot(ta, tb, scheme="dot2"))),
    ]:
        print(f"  {name:24s} {val:.9e}  relerr={numerics.relative_error(val, exact):.2e}")

    # 2. Compensated summation: 1.0 added to 1e8, 4096 times, in fp32.
    x = np.concatenate([[1e8], np.ones(4096)]).astype(np.float32)
    tx = torch.from_numpy(x).to(dev)
    print("\nsum of 1e8 + 4096 ones (fp32):")
    print(f"  naive torch.sum : {float(torch.sum(tx)):.1f}")
    print(f"  kahan_sum     : {float(kahan_sum(tx)):.1f}"
          "   (exact: 100004096)")

    # 3. One Policy selects scheme x unroll x blocks x ACCUMULATE DTYPE
    #    for every kernel. compute_dtype=float64 turns the engine into its
    #    own verification oracle: the f64-accumulated batched matmul is
    #    the reference the fp32 run is judged against.
    rng = np.random.default_rng(0)
    A = torch.from_numpy((rng.standard_normal((2, 16, 2048)) * 10)
                         .astype(np.float32)).to(dev)
    B = torch.from_numpy((rng.standard_normal((2, 2048, 128)) * 10)
                         .astype(np.float32)).to(dev)
    c32 = {}
    for scheme in ("naive", "kahan"):
        with use_policy(scheme=scheme, blocks=(16, 128, 256)):
            c32[scheme] = ops.batched_matmul(A, B).double().cpu().numpy()
    with use_policy(scheme="kahan", compute_dtype=torch.float64,
                    blocks=(16, 128, 256)):
        c64 = ops.batched_matmul(A, B).cpu().numpy()
    print("\nbatched_matmul [2,16,2048]@[2,2048,128], fp32 vs f64-verify:")
    for scheme, c in c32.items():
        err = np.abs(c - c64).max() / np.abs(c64).max()
        print(f"  {scheme:6s} fp32 accumulate: max relerr vs f64 {err:.2e}")

    # 4. Request-level serving: the continuous-batching engine admits
    #    each request into a decode slot, samples with its own stream, and
    #    keeps its tokens + compensated telemetry bitwise identical solo
    #    or under traffic.
    from repro_torch.configs import get_smoke
    from repro_torch.serve import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)

    engine = InferenceEngine(get_smoke("olmo-1b"),
                             EngineConfig(max_slots=2, max_len=16,
                                          track_stats=True), device=dev)
    handles = engine.run([Request(prompt=[3, 1, 4, 1, 5],
                                  sampling=SamplingParams(max_new_tokens=4)),
                          Request(prompt=[2, 7],
                                  sampling=SamplingParams(max_new_tokens=2))])
    print("\nserved:", {rid: h.tokens for rid, h in sorted(handles.items())})

    # 5. The ECM model on the H100: the dot kernel (B1) at the paper's
    #    n = 2^27, naive against kahan, from the scheme registry.
    from repro_torch.core import ecm

    for scheme in ("naive", "kahan"):
        r = ecm.ecm_gpu_for_scheme(ecm.H100, scheme, 1 << 27, 8)
        print(f"\nECM {ecm.H100.name} dot {scheme} (U = 8): "
              f"{r.shorthand()}\n  -> {r.pred_ms:.4f} ms ({r.bound}-bound; "
              f"bytes bound {r.bytes_bound_ms:.4f} ms)")


if __name__ == "__main__":
    main()

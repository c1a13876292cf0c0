#!/usr/bin/env python3
"""Does the JAX reference's prefix cache keep a hybrid's tokens? (CPU;
needs jax and the JAX package.)

    PYTHONPATH=src python3 scripts/hymba_prefix_reference.py

Serves hymba-1.5b's smoke config (window 16, global layers 0 and 3) on
the reference engine's paged layout (pages of 4 positions, chunks of 4,
greedy, telemetry under kahan) twice: with ``prefix_cache`` off and on.
Two requests share their first 8 prompt tokens (two full pages); the
second arrives after the first has finished, so with the cache on it
admits by reference to the first's pages and resumes prefill past them.
Its ring rows and SSM state for those positions are never computed (the
tree shares only pageable leaves), so its tokens may differ from the
private run's. Prints each run's tokens, the prefix-hit tokens and
whether the two runs agree.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import numpy as np

    from repro.configs import get_smoke
    from repro.kernels.schemes import Policy
    from repro.models import build_model
    from repro.serve import (EngineConfig, InferenceEngine, Request,
                             SamplingParams)

    cfg = get_smoke("hymba-1.5b")
    model = build_model(cfg)
    params, _ = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, (8,))
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, (n,))])
               .astype(np.int32) for n in (5, 6)]
    out = {}
    for prefix in (False, True):
        ec = EngineConfig(max_slots=2, max_len=32, track_stats=True,
                          prefill_chunk=4, kv_layout="paged", page_size=4,
                          prefix_cache=prefix, policy=Policy(scheme="kahan"))
        engine = InferenceEngine(cfg, ec, model=model, params=params)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=6),
                        request_id=i) for i, p in enumerate(prompts)]
        served = engine.run(reqs, [0, 12])
        out[prefix] = {rid: (h.tokens, h.telemetry)
                       for rid, h in served.items()}
        print(f"prefix_cache={prefix}: kv_layout={engine.kv_layout} "
              f"prefix_hit_tokens={engine.page_stats()['prefix_hit_tokens']} "
              f"tokens={ {rid: t for rid, (t, _) in out[prefix].items()} }")
    same = all(out[True][rid] == out[False][rid] for rid in out[False])
    print(f"tokens and telemetry equal with and without the prefix cache: "
          f"{same}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

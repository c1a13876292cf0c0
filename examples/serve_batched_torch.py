"""Request-level serving with the PyTorch/CUDA port: continuous batching
over the model-zoo API (``examples/serve_batched.py`` over
``repro_torch``).

Submits a staggered trace of mixed-length requests to
``repro_torch.serve.InferenceEngine``: a fixed decode batch of
``--max-slots`` per-slot KV caches, where finished requests free their
slot mid-flight and queued requests are prefilled into the gap IN
CHUNKS — each prompt is split into ``--prefill-chunk``-token chunks
(partial tails round up to power-of-two buckets), so the mixed prompt
lengths here run a handful of prefill shapes instead of one per distinct
length, and ``--prefill-budget 1`` bounds how long any admission can
stall the requests already decoding.

The trace is also a SHARED-SYSTEM-PROMPT demo: every request starts
with the same ``--system-len`` system-prompt tokens. Under the default
paged KV layout with the prefix cache on, the first request to finish
leaves its full prompt pages in the radix prefix tree, and every later
admission walks the shared system prompt by REFERENCE (watch ``hit=``
climb in the step log). ``--dense`` reverts to the dense slot layout.

Each request's tokens and compensated logit-norm telemetry are bitwise
identical to serving it alone, to the dense layout, AND to a private
(unshared) prefill (``tests/test_torch_serve.py`` and
``tests/test_torch_paging.py`` hold the contract).

    PYTHONPATH=src python examples/serve_batched_torch.py \\
        [--arch qwen2.5-3b] [--prefill-chunk 8] [--prefill-budget 1] \\
        [--system-len 16] [--dense] [--device cpu]

Runs on the card by default; ``--device cpu`` runs the kernels' plain
versions.
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke
from repro_torch.serve import (EngineConfig, InferenceEngine, Request,
                               SamplingParams)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--max-slots", type=int, default=2)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt-chunk width (0 -> one-shot admit: one "
                         "prefill shape per distinct prompt length)")
    ap.add_argument("--prefill-budget", type=int, default=1,
                    help="max prefill chunks per engine step (0 -> "
                         "unbounded)")
    ap.add_argument("--system-len", type=int, default=16,
                    help="shared system-prompt tokens prepended to every "
                         "request (>= one 16-token page -> later "
                         "admissions take it by reference from the "
                         "prefix cache)")
    ap.add_argument("--dense", action="store_true",
                    help="use the dense slot layout (no page pool, no "
                         "prefix cache) — same tokens, every prompt "
                         "prefilled privately")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)  # reduced config: runnable on the CPU
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size,
                          (args.system_len,)).astype(np.int32)
    # mixed prompt/output lengths, staggered arrivals, all sharing the
    # system prompt, the shape the prefix cache exists for
    requests, arrivals = [], []
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        new = int(rng.integers(2, args.new_tokens + 1))
        user = rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
        requests.append(Request(
            prompt=np.concatenate([system, user]),
            sampling=SamplingParams(max_new_tokens=new)))
        arrivals.append(i // 2)  # two arrivals per engine step
    n_lengths = len({len(np.asarray(r.prompt)) for r in requests})

    engine = InferenceEngine(
        cfg, EngineConfig(max_slots=args.max_slots, max_len=64,
                          track_stats=True,
                          prefill_chunk=args.prefill_chunk or None,
                          prefill_budget=args.prefill_budget or None,
                          kv_layout="dense" if args.dense else "paged",
                          page_size=16,
                          prefix_cache=not args.dense),
        device=args.device)
    paged = engine.kv_layout == "paged"
    t0 = time.perf_counter()
    n_tok = 0
    for t, events in engine.stream(requests, arrivals):
        n_tok += len(events)
        line = ", ".join(f"r{e.request_id}:{e.token}{'*' if e.done else ''}"
                         for e in events)
        pages = ""
        if paged:
            st = engine.page_stats()
            pages = (f" pages={st['pages_in_use']}/{st['num_pages']}"
                     f" hit={st['prefix_hit_tokens']}tok")
        print(f"step {t:2d} occ={engine.scheduler.occupancy} "
              f"prefilling={len(engine.scheduler.prefilling)}{pages}  "
              f"{line}")
    dt = time.perf_counter() - t0

    for rid, h in sorted(engine.handles.items()):
        print(f"request {rid}: {h.tokens}  "
              f"|logits|^2 last={h.telemetry[-1]:.4e}")
    progs = list(engine.prefill_programs)
    print(f"{n_lengths} distinct prompt lengths -> {len(progs)} prefill "
          f"shapes {progs} (one-shot would need {n_lengths})")
    if paged:
        st = engine.page_stats()
        print(f"prefix cache: {st['prefix_hit_tokens']} prompt tokens "
              f"admitted by reference ({st['prefix_pages']} resident "
              f"pages; every token bitwise-equal to a private prefill)")
    print(f"wall: {dt:.2f}s  ({n_tok / dt:.1f} tok/s, "
          f"{len(requests)} requests over {engine.t} steps)")


if __name__ == "__main__":
    main()

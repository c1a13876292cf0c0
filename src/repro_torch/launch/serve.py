"""Serving launcher of the port: it runs a request trace through the
continuous-batching engine (counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --trace 0:64:16,0:128:16,2:32:16,5:96:16 --stats --scheme kahan

runs OLMo-1B at its published width on the card with random weights made
from ``--seed``. ``--smoke`` selects the reduced config, ``--device cpu``
runs on the CPU (the kernels' plain versions). ``--trace`` cells are
``arrival:prompt_len:new_tokens[:temperature]`` (arrival in engine
steps); without it a uniform batch comes from ``--batch`` /
``--prompt-len`` / ``--new-tokens``. ``--stats`` prints the compensated
per-request squared logit norms: one batched sum-kernel launch per decode
tick over the whole slot batch.

``--prefill-mode flash`` runs each prompt chunk in one forward pass
(``prefill_chunk_parallel``); its attention goes through the chunk flash
kernel when the config has ``kahan_attention``, else through the
materialized attention core. A config without the parallel path runs the
scan body, with a notice.

``--kv-layout paged`` keeps the KV cache in a page pool addressed
through per-request page tables (``--page-size`` / ``--num-pages`` size
it; live KV memory then scales with live tokens), and ``--prefix-cache``
keeps finished prompts' pages in a radix tree so that shared prompt
prefixes admit by reference. Both give the dense layout's tokens and
telemetry bit for bit; the per-step line then carries the pool's
counters. A VLM config (``--arch internvl2-2b``) gets each request's
patch embeddings drawn from ``--seed`` as its ``vision_embeds``. The
hybrid ``--arch hymba-1.5b`` runs the scan body whatever
``--prefill-mode`` asks, pages only its global layers (its rings and
SSM state stay dense) and refuses ``--prefix-cache``; so does
``--arch xlstm-1.3b``, whose recurrent state pages nowhere (``--kv-layout
paged`` serves it on the dense layout). ``--arch whisper-large-v3`` gets
each request's encoder frames ``[n_frames, d_model]`` drawn from
``--seed``; its self-attention K/V page, its cross K/V stay dense slot
rows, and its requests never share a prefix.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --smoke --device cpu --trace 0:32:4,1:40:4 --kv-layout paged \
        --prefix-cache --stats

The flags are the reference launcher's, plus ``--device``.
"""

import argparse
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.kernels import Policy, schemes
from repro_torch.serve import (
    EngineConfig,
    InferenceEngine,
    Request,
    SamplingParams,
)


def parse_trace(spec: str, default_temp: float,
                ) -> List[Tuple[int, int, int, float]]:
    """'arrival:prompt_len:new_tokens[:temperature],...' -> tuples,
    every cell validated at the parse boundary."""
    cells = []
    for cell in spec.split(","):
        parts = cell.strip().split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"trace cell {cell!r}: want arrival:prompt_len:new_tokens"
                "[:temperature]")
        arrival, plen, new = (int(p) for p in parts[:3])
        temp = float(parts[3]) if len(parts) == 4 else default_temp
        if arrival < 0:
            raise ValueError(f"trace cell {cell!r}: arrival must be >= 0 "
                             f"(engine steps), got {arrival}")
        if plen < 1:
            raise ValueError(f"trace cell {cell!r}: prompt_len must be >= 1, "
                             f"got {plen}")
        if new < 1:
            raise ValueError(f"trace cell {cell!r}: new_tokens must be >= 1, "
                             f"got {new}")
        if temp < 0:
            raise ValueError(f"trace cell {cell!r}: temperature must be >= 0 "
                             f"(0 = greedy), got {temp}")
        cells.append((arrival, plen, new, temp))
    return cells


def build_requests(cfg, cells, seed: int):
    """Requests with prompts (and, for a VLM config, patch embeddings,
    for an encoder-decoder config frames, drawn first) from ``seed``, in
    the reference launcher's order; request_id = cell index."""
    rng = np.random.default_rng(seed)
    requests, arrivals = [], []
    for arrival, plen, new, temp in cells:
        extras = {}
        if cfg.vision is not None:
            extras["vision_embeds"] = rng.standard_normal(
                (cfg.vision.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.encoder is not None:
            extras["frames"] = rng.standard_normal(
                (cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
        extras = extras or None
        requests.append(Request(
            prompt=rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32),
            sampling=SamplingParams(temperature=temp, max_new_tokens=new),
            request_id=len(requests), extras=extras))
        arrivals.append(arrival)
    return requests, arrivals


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--trace", default="")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-slot cache capacity; 0 -> fit the trace")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="prompt-chunk width; 0 -> one-shot prefill")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max prefill chunks per engine step; 0 -> unbounded")
    ap.add_argument("--prefill-mode", default="scan",
                    help="chunk body: 'scan' (per-position oracle) or "
                         "'flash' (one forward pass per chunk)")
    ap.add_argument("--kv-layout", default="dense",
                    help="'dense' (a max_len row per slot) or 'paged' (a "
                         "page pool with per-request page tables)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="positions a KV page (a power of two; max_len is "
                         "rounded up to a multiple). Paged layout only")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool capacity; 0 -> dense parity (max_slots "
                         "* max_len / page_size). Paged layout only")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share finished prompts' full pages through a "
                         "radix tree (requires --kv-layout paged)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the prompts and the random weights")
    ap.add_argument("--stats", action="store_true",
                    help="print compensated per-request logit norms")
    ap.add_argument("--scheme", default="kahan",
                    help="compensation scheme of the telemetry "
                         f"(registered: {', '.join(sorted(schemes.names()))})")
    ap.add_argument("--unroll", type=int, default=8)
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.prefill_mode not in ("scan", "flash"):
        raise ValueError(f"--prefill-mode must be 'scan' or 'flash', got "
                         f"{args.prefill_mode!r}")
    if args.kv_layout not in ("dense", "paged"):
        raise ValueError(f"--kv-layout must be 'dense' or 'paged', got "
                         f"{args.kv_layout!r}")
    if args.prefix_cache and args.kv_layout != "paged":
        raise ValueError("--prefix-cache requires --kv-layout paged (prefix "
                         "sharing is page-granular)")

    cells = (parse_trace(args.trace, args.temperature) if args.trace else
             [(0, args.prompt_len, args.new_tokens, args.temperature)]
             * args.batch)
    policy = Policy(scheme=args.scheme, unroll=args.unroll,
                    compute_dtype=args.compute_dtype)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    max_len = args.max_len or max(p + n for _, p, n, _ in cells)
    if args.kv_layout == "paged" and max_len % args.page_size:
        # a fitted max_len rounds up to the next page boundary
        max_len += args.page_size - max_len % args.page_size
    requests, arrivals = build_requests(cfg, cells, args.seed)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    engine = InferenceEngine(
        cfg, EngineConfig(max_slots=args.max_slots, max_len=max_len,
                          track_stats=args.stats, policy=policy,
                          prefill_chunk=args.prefill_chunk or None,
                          prefill_budget=args.prefill_budget or None,
                          prefill_mode=args.prefill_mode,
                          kv_layout=args.kv_layout,
                          page_size=args.page_size,
                          num_pages=args.num_pages or None,
                          prefix_cache=args.prefix_cache),
        seed=args.seed, device=device)
    if args.kv_layout == "paged" and engine.kv_layout == "dense":
        print(f"# kv-layout 'paged' requested but family {cfg.family!r} "
              f"has no pageable KV leaf (ring or recurrent state only): "
              f"running the dense layout")
    if engine.prefill_body != args.prefill_mode:
        print(f"# prefill-mode {args.prefill_mode!r} requested but family "
              f"{cfg.family!r} runs the {engine.prefill_body!r} body "
              f"(per-position fallback: recurrent state or unsupported "
              f"config)")
    paged = engine.kv_layout == "paged"
    for t, events in engine.stream(requests, arrivals):
        chunks = " ".join(f"r{rid}+{w}/{body}"
                          for rid, w, body in engine.last_chunks)
        emitted = ", ".join(
            f"r{e.request_id}:{e.token}{'*' if e.done else ''}"
            for e in events)
        pages = ""
        if paged:
            st = engine.page_stats()
            pages = (f" pages={st['pages_in_use']}/{st['num_pages']}"
                     f" stalls={st['page_stalls']}")
            if args.prefix_cache:
                pages += (f" prefix-hit={st['prefix_hit_tokens']}tok"
                          f" cached={st['prefix_cached_pages']}pg")
        print(f"# step {t:3d} occupancy={engine.scheduler.occupancy} "
              f"prefilling={len(engine.scheduler.prefilling)} "
              f"queued={engine.scheduler.queued}{pages}"
              f"{'  chunks: ' + chunks if chunks else ''}  {emitted}")
    if paged:
        st = engine.page_stats()
        print(f"# kv-layout=paged page_size={args.page_size} "
              f"pool={st['num_pages']} free={st['free_pages']} "
              f"prefix_pages={st['prefix_pages']} "
              f"prefix_hit_tokens={st['prefix_hit_tokens']} "
              f"page_stalls={st['page_stalls']} "
              f"kv_bytes_in_use={st['kv_bytes_in_use']}")
    for rid, h in sorted(engine.handles.items()):
        arrival, plen, new, temp = cells[rid]
        print(f"request {rid} (arrived t={arrival}, prompt={plen}, "
              f"new={new}, temp={temp}): {h.tokens}")
        if args.stats and h.telemetry:
            print(f"request {rid}: |logits|^2 ({args.scheme}) "
                  f"first={h.telemetry[0]:.6e} last={h.telemetry[-1]:.6e}")


if __name__ == "__main__":
    main()

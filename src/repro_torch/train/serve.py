"""The serving steps the dry run runs for the prefill and decode cells
(counterpart of ``repro/train/serve.py``'s ``make_prefill_step`` and
``make_decode_step``). The reference's deprecated lock-step ``Server``
shim is not carried: request-level serving is ``repro_torch.serve``."""

from __future__ import annotations

from typing import Callable

#: batch entries a model's prefill takes beside the tokens
PREFILL_EXTRAS = ("vision_embeds", "frames")


def make_prefill_step(model) -> Callable:
    """``(params, batch, cache) -> (logits [B, V_pad], cache)``: the
    whole-prompt prefill of ``batch["tokens"]`` (a VLM's
    ``vision_embeds``, an encoder-decoder's ``frames`` passed on; the
    training entries ignored)."""
    def prefill_step(params, batch, cache):
        extras = {k: batch[k] for k in PREFILL_EXTRAS if k in batch}
        return model.prefill(params, batch["tokens"], cache, **extras)

    return prefill_step


def make_decode_step(model) -> Callable:
    """``(params, cache, tokens [B], pos) -> (logits [B, V_pad], cache)``:
    one position, the cache written in place."""
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos), cache

    return decode_step

"""Serving steps: single-token decode, greedy or temperature sampling, and
the greedy generation loop (counterpart of :mod:`repro.train.serve_step`).
PyTorch runs eagerly, so the JAX package's ``jax.jit`` wrappers and its
``make_prefill`` (a wrapper to jit) have no counterpart here: call
``model.prefill``.  The prefill writes its keys and values straight into
the generation's cache of ``cache_len`` slots, so nothing is padded or
copied afterwards; ``cache_len`` sizes only the self-attention caches (a
Mamba layer's state and conv tails have no length axis), and each
cross-attention cache holds the prompt batch's memory (``media`` or
``src_embeds``) at its own length, where the JAX package pads it to the
config's length with zero keys that dilute every decode step's
attention."""

from __future__ import annotations

from typing import Optional

import torch


def make_decode_step(model, *, sample: Optional[str] = None, temperature: float = 1.0):
    """decode_step(params, caches, tokens, pos[, generator]) → (next tokens
    (B, 1) | logits, caches).  Temperature sampling draws from the explicit
    ``torch.Generator`` (on the logits' device)."""
    if sample not in (None, "greedy", "temperature"):
        raise ValueError(sample)

    def decode(params, caches, tokens, pos, generator: Optional[torch.Generator] = None):
        logits, caches = model.decode_step(params, caches, tokens, pos)
        if sample is None:
            return logits, caches
        if sample == "greedy":
            return logits[:, -1, :].argmax(dim=-1, keepdim=True), caches
        probs = torch.softmax(logits[:, -1, :].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator), caches

    return decode


def generate(model, params, prompt_batch, steps: int, cache_len: int) -> torch.Tensor:
    """Greedy generation (host-side loop) → ``(B, steps)`` token ids."""
    decode = make_decode_step(model, sample="greedy")
    B, prompt_len = prompt_batch["tokens"].shape
    caches = model.init_cache(B, cache_len, device=prompt_batch["tokens"].device,
                              mem_len=model.memory_len(prompt_batch))
    logits, caches = model.prefill(params, prompt_batch, caches)
    tokens = logits[:, -1, :].argmax(dim=-1, keepdim=True)
    out = [tokens]
    pos = prompt_len
    for _ in range(steps - 1):
        tokens, caches = decode(params, caches, tokens, pos)
        out.append(tokens)
        pos += 1
    return torch.cat(out, dim=1)

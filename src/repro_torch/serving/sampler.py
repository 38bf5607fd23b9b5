"""Token sampling: greedy / temperature / top-p (port of
``repro.serving.sampler``).

Greedy (temperature 0) is ``argmax`` — first index on ties, as in JAX —
and matches the reference exactly. At temperature > 0 the JAX package
draws with threefry keys (``jax.random.fold_in``), which torch cannot
reproduce. The port keeps the PROPERTY that matters to serving: a draw
is a pure function of (seed, token index), independent of batch
composition and admission order, through a ``torch.Generator`` on the
logits' device seeded from those two numbers, so a draw on the card
needs no copy of the logits to the host. Parity with the JAX package at
temperature > 0 is therefore statistical only (and a draw on the card
differs from the draw on the CPU for the same pair).
"""
from __future__ import annotations

import hashlib
from typing import Optional

import torch


def request_generator(seed: int, token_idx: int,
                      device="cpu") -> torch.Generator:
    """Generator on ``device`` for one (request, token) draw, seeded from
    a hash of (seed, token_idx): same pair, same device, same draw, on
    every run."""
    h = hashlib.blake2b(repr((int(seed), int(token_idx))).encode(),
                        digest_size=8)
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h.digest(), "big") >> 1)


def sample_token(gen: Optional[torch.Generator], logits, *,
                 temperature: float = 0.0, top_p: float = 1.0):
    """logits [B, V] -> token ids [B] (int64, on the logits' device).
    ``gen`` must live on that device; it is unused when
    ``temperature <= 0``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set with cumulative prob >= top_p
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True).clamp(
            max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]

"""Expert pre-fetch predictors (port of ``repro.core.prefetch``).

``SpeculativePrefetcher`` is the paper's §3.2/§4.3 algorithm: because
transformer layers are residual, layer l's post-attention hidden state
is a good stand-in for layer l+1's input, so applying layer l+1's
gating network to it predicts l+1's experts (softmax + top-k).

``MarkovPredictor`` is a beyond-paper baseline in the same spirit as
the paper's §6.1 "learning-based prediction" direction: a per-layer
first-order transition table from layer l's activated set to layer
l+1's.

``LearnedPredictor`` completes that direction (FlashMoE / MoE-Beyond):
the same per-layer transition statistics PLUS an offline-trained
logistic model (``repro_torch.core.learned``) over each layer's recent
activation window — recency/frequency traces the transition table
alone cannot express. With no model attached it degrades to exactly
the Markov ranking.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.learned import LayerState, LearnedModel
from repro_torch.models.layers import rms_norm


class SpeculativePrefetcher:
    """Gate-ahead guessing. Stateless; pure function of activations."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.k = cfg.num_experts_per_tok

    def guess(self, h_after_attn, next_ln_w, next_router) -> Tuple[int, ...]:
        """h_after_attn [B,1,d] (layer l, post-attention residual);
        next_ln_w / next_router: layer l+1's pre-FFN norm + gate weights.
        Returns the union of per-sequence top-k guesses. The top-k is
        the host ``np.argsort`` of the reference, so ties break alike."""
        x = rms_norm(h_after_attn, next_ln_w, self.cfg.norm_eps)
        logits = (x.float() @ next_router)[:, 0, :].cpu().numpy()
        ids = np.argsort(-logits, axis=-1)[:, :self.k]  # [B, k]
        # np.unique == sorted set union (vectorized over the batch)
        return tuple(int(e) for e in np.unique(ids))


class MarkovPredictor:
    """First-order expert-transition predictor (beyond paper)."""

    def __init__(self, num_layers: int, num_experts: int, k: int):
        self.L, self.E, self.k = num_layers, num_experts, k
        # counts[l][from_e, to_e]: layer l activation -> layer l+1 activation
        self.counts = np.ones((num_layers, num_experts, num_experts), np.float32)

    def update(self, layer: int, cur: Sequence[int], nxt: Sequence[int]) -> None:
        if layer + 1 >= self.L:
            return
        for a in cur:
            for b in nxt:
                self.counts[layer, a, b] += 1.0

    def predict(self, layer: int, cur: Sequence[int]) -> Tuple[int, ...]:
        """Predict layer+1's experts from layer's activated set."""
        if not cur:
            return ()
        score = self.counts[layer, list(cur), :].sum(axis=0)
        ids = np.argsort(-score)[: self.k]
        return tuple(sorted(int(i) for i in ids))


class LearnedPredictor:
    """Markov transition statistics + learned activation model.

    The engine drives it exactly like ``MarkovPredictor`` (``update``
    after each layer, ``predict`` for the next one) plus one extra
    hook: ``observe(layer, acts)`` keeps per-layer feature state
    (``learned.LayerState``) in the same walk the model was trained
    on. ``predict`` ranks layer l+1's experts by the model's reuse
    probability, with the transition row as one feature — so the
    learned ranking can only use the Markov signal, never lose it —
    and falls back to the pure transition ranking when no model is
    attached.
    """

    def __init__(self, num_layers: int, num_experts: int, k: int,
                 model: Optional[LearnedModel] = None):
        self.L, self.E, self.k = num_layers, num_experts, k
        self.model = model
        self.markov = MarkovPredictor(num_layers, num_experts, k)
        decays = tuple(getattr(model, "decays", None) or
                       LayerState(1).decays)
        gamma = float(getattr(model, "gamma", LayerState(1).gamma))
        self.states = [LayerState(num_experts, decays=decays, gamma=gamma)
                       for _ in range(num_layers)]

    def update(self, layer: int, cur: Sequence[int],
               nxt: Sequence[int]) -> None:
        self.markov.update(layer, cur, nxt)

    def observe(self, layer: int, acts: Sequence[int]) -> None:
        self.states[layer].observe(acts)

    def predict(self, layer: int, cur: Sequence[int]) -> Tuple[int, ...]:
        """Predict layer+1's experts from layer's activated set."""
        if not cur or layer + 1 >= self.L:
            return ()
        mass = self.markov.counts[layer, list(cur), :].sum(axis=0)
        tot = float(mass.sum())
        row = mass / tot if tot > 0 else None
        if self.model is None:
            score = mass
        else:
            score = self.model.predict(self.states[layer + 1].features(row))
        ids = np.argsort(-np.asarray(score), kind="stable")[: self.k]
        return tuple(sorted(int(i) for i in ids))

"""Data pipeline (the port's own copy of ``repro.data.pipeline``, which is
numpy only: the same generators, the same draws from the same seeds, so
batches and workloads are bitwise the JAX package's).

Two kinds of synthetic workloads (no datasets are downloaded):

1. ``markov_lm`` / ``lm_batches`` — a learnable synthetic language: a
   first-order Markov chain over the vocabulary with a Zipfian
   stationary distribution and a few long-range "topic" tokens. Models
   trained on it develop the uneven, topic-dependent expert routing the
   paper analyses.

2. ``ExpertWorkload`` — direct per-(token, layer) expert-activation
   sequences with *controllable* imbalance (Zipf exponent) and temporal
   locality (P[token t repeats an expert of token t-1]), calibrated to
   the paper's reported statistics (§3.1: locality ≈ 30% > 2/8 random;
   §5.2: strong per-layer imbalance). Used to compare cache policies
   under known ground truth.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np


# ---------------------------------------------------------------------
# synthetic language for training
# ---------------------------------------------------------------------
def _zipf_probs(n: int, s: float, rng: np.random.Generator) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-s)
    rng.shuffle(p)
    return p / p.sum()


def markov_lm(vocab: int, *, seed: int = 0, branch: int = 24,
              zipf_s: float = 1.2):
    """Returns (init_probs [V], next_token sampler state).

    Each token has ``branch`` plausible successors with Zipfian weights;
    successor tables are drawn once from the seed so the language is a
    fixed distribution.
    """
    rng = np.random.default_rng(seed)
    init = _zipf_probs(vocab, zipf_s, rng)
    succ = rng.integers(0, vocab, size=(vocab, branch))
    w = _zipf_probs(branch, 1.1, rng)
    return init, succ, w


def lm_batches(vocab: int, batch: int, seq: int, n_batches: int, *,
               seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'tokens': [B,S], 'labels': [B,S]} int32 batches."""
    init, succ, w = markov_lm(vocab, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for _ in range(n_batches):
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.choice(vocab, size=batch, p=init)
        for t in range(seq):
            choice = rng.choice(succ.shape[1], size=batch, p=w)
            toks[:, t + 1] = succ[toks[:, t], choice]
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


# ---------------------------------------------------------------------
# calibrated expert-activation workloads
# ---------------------------------------------------------------------
@dataclasses.dataclass
class ExpertWorkload:
    """Per-layer expert activation sequences: acts[layer][token] = ids."""
    num_layers: int
    num_experts: int
    top_k: int
    acts: List[List[Tuple[int, ...]]]

    def layer_sequence(self, layer: int) -> List[Tuple[int, ...]]:
        return self.acts[layer]

    def flat_future(self, layer: int) -> List[int]:
        out: List[int] = []
        for ids in self.acts[layer]:
            out.extend(ids)
        return out

    def measured_locality(self, layer: int) -> float:
        seq = self.acts[layer]
        num = den = 0
        for t in range(1, len(seq)):
            num += len(set(seq[t]) & set(seq[t - 1]))
            den += len(seq[t])
        return num / den if den else 0.0


def workload_from_paper_stats(*, num_layers: int = 32, num_experts: int = 8,
                              top_k: int = 2, n_tokens: int = 256,
                              zipf_s: float = 1.0, locality: float = 0.3,
                              seed: int = 0) -> ExpertWorkload:
    """Generate activations with Zipfian expert popularity (per layer)
    and first-order temporal locality: with prob ``locality`` each of a
    token's experts repeats one of the previous token's, otherwise it is
    drawn from the layer's popularity distribution.

    zipf_s ≈ 1.0 reproduces the paper's Fig 7 skew (a couple of experts
    dominate, one rarely fires); locality=0.3 matches the "sometimes
    near 30%" §3.1 statistic.
    """
    rng = np.random.default_rng(seed)
    acts: List[List[Tuple[int, ...]]] = []
    for l in range(num_layers):
        pop = _zipf_probs(num_experts, zipf_s, rng)
        seq: List[Tuple[int, ...]] = []
        prev: Tuple[int, ...] = ()
        for t in range(n_tokens):
            ids: List[int] = []
            for j in range(top_k):
                if prev and rng.random() < locality:
                    cand = [e for e in prev if e not in ids]
                    if cand:
                        ids.append(int(rng.choice(cand)))
                        continue
                p = pop.copy()
                if ids:
                    p[ids] = 0.0
                    p = p / p.sum()
                ids.append(int(rng.choice(num_experts, p=p)))
            ids_t = tuple(sorted(ids))
            seq.append(ids_t)
            prev = ids_t
        acts.append(seq)
    return ExpertWorkload(num_layers, num_experts, top_k, acts)


def drifting_workload(*, num_layers: int = 4, num_experts: int = 8,
                      top_k: int = 2, n_tokens: int = 256, phases: int = 2,
                      zipf_s: float = 1.0, locality: float = 0.2,
                      seed: int = 0) -> ExpertWorkload:
    """Piecewise-stationary workload: ``phases`` back-to-back segments
    of ``workload_from_paper_stats``, each with an independently drawn
    (same-skew) popularity ordering — the request-mix shift a serving
    cache sees when the prompt distribution moves. Popularity-only
    policies (persistent LFU) cling to the stale ordering after a
    phase switch; recency-only ones (LRU) never exploit the skew — the
    regime where learned replacement shows its value."""
    segs = [workload_from_paper_stats(
        num_layers=num_layers, num_experts=num_experts, top_k=top_k,
        n_tokens=n_tokens, zipf_s=zipf_s, locality=locality,
        seed=seed + 7919 * i) for i in range(phases)]
    acts = [[ids for s in segs for ids in s.acts[l]]
            for l in range(num_layers)]
    return ExpertWorkload(num_layers, num_experts, top_k, acts)

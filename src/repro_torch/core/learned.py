"""Learned expert-activation prediction — the paper's §6.1 direction.

The paper stops at classical policies (LRU → LFU) plus gate-based
speculation and names "learning-based prediction" as the natural next
step; FlashMoE (arXiv:2601.17063) and MoE-Beyond (arXiv:2508.17137)
show ML replacement/prediction beating LRU/LFU on exactly this
workload. This module is the shared substrate:

  * per-(layer, expert) feature extraction from ``TraceRecorder``
    histories (``extract_dataset``),
  * a small logistic model over the recent activation window, trained
    OFFLINE by deterministic full-batch gradient descent — pure numpy,
    no RNG, so the same trace always yields the same weights
    (``train_model`` / ``train_from_trace``),
  * ``.npz`` weight serialization (``LearnedModel.save``/``load``),
  * next-window reuse scoring consumed by
    ``cache_policies.LearnedPolicy`` (eviction by predicted reuse) and
    ``prefetch.LearnedPredictor`` (lookahead augmenting the Markov
    transition table).

Feature vector (per layer, expert, token-time; state BEFORE the step):

  0  bias (1.0)
  1‥3  exponential activation traces at decays ``DECAYS`` — multi-
       timescale popularity: the fast trace is ~recency, the slow one
       ~frequency, so the trained weights are a data-fitted LRU/LFU
       mix (cf. LRFU, whose single λ is hand-picked)
  4  lifetime marginal activation frequency
  5  recency kernel ``GAMMA**gap`` (gap = layer-steps since last
     activation; 0.0 if never activated)
  6  same-token previous-layer transition mass (row-normalized Markov
     counts summed over the previous layer's activated set). NaN when
     no layer context exists — the eviction-policy use — and imputed
     with the training mean at predict time.

The transition counts are accumulated CAUSALLY during extraction (a
sample at token t only sees transitions from tokens < t and earlier
layers of t), matching what an online predictor would have known.
"""
from __future__ import annotations

import json
import warnings
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DECAYS = (0.5, 0.9, 0.98)
GAMMA = 0.8


class ModelLoadError(ValueError):
    """A ``LearnedModel`` checkpoint could not be loaded (missing file,
    truncated/corrupt archive, missing arrays, wrong shapes). A
    ``ValueError`` so generic callers need no new except clause."""
N_FEATURES = 7


class LayerState:
    """Online per-layer feature state over one expert population.

    Mirrors, exactly, the state walk ``extract_dataset`` performs while
    building training data — the prefetch predictor keeps one per layer
    so its features match the training distribution.
    """

    def __init__(self, num_experts: int, *, decays: Sequence[float] = DECAYS,
                 gamma: float = GAMMA):
        self.E = num_experts
        self.decays = tuple(decays)
        self.gamma = gamma
        self.t = 0                                   # layer-steps observed
        self.traces = np.zeros((len(self.decays), num_experts), np.float64)
        self.counts = np.zeros(num_experts, np.float64)
        self.last_act = np.full(num_experts, -(1 << 30), np.int64)

    def features(self, transition: Optional[np.ndarray] = None) -> np.ndarray:
        """[E, N_FEATURES] raw feature rows for every expert, from the
        state BEFORE the next observation. ``transition`` is the
        normalized previous-layer transition row (NaN-imputed later
        when None)."""
        E = self.E
        X = np.empty((E, N_FEATURES), np.float64)
        X[:, 0] = 1.0
        for i in range(len(self.decays)):
            X[:, 1 + i] = self.traces[i]
        X[:, 4] = self.counts / max(self.t, 1)
        gap = self.t - self.last_act
        X[:, 5] = np.where(self.last_act < 0, 0.0,
                           self.gamma ** np.minimum(gap, 512))
        X[:, 6] = np.nan if transition is None else transition
        return X

    def observe(self, activated: Sequence[int]) -> None:
        onehot = np.zeros(self.E, np.float64)
        acts = [int(e) for e in activated]
        if acts:
            onehot[acts] = 1.0
        for i, d in enumerate(self.decays):
            self.traces[i] = self.traces[i] * d + onehot
        self.counts += onehot
        if acts:
            self.last_act[acts] = self.t
        self.t += 1


class LearnedModel:
    """Logistic reuse-probability model + its feature normalization."""

    def __init__(self, w: np.ndarray, mean: np.ndarray, std: np.ndarray, *,
                 decays: Sequence[float] = DECAYS, gamma: float = GAMMA,
                 confidence: float = 0.0, meta: Optional[dict] = None):
        self.w = np.asarray(w, np.float64)
        self.mean = np.asarray(mean, np.float64)
        self.std = np.asarray(std, np.float64)
        self.decays = tuple(float(d) for d in decays)
        self.gamma = float(gamma)
        self.confidence = float(confidence)
        self.meta = dict(meta or {})

    def predict(self, X) -> np.ndarray:
        """Reuse probabilities for raw feature rows [n, N_FEATURES].
        NaNs (missing transition context) impute to the training mean."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        X = np.where(np.isnan(X), self.mean, X)
        Z = (X - self.mean) / self.std
        return 1.0 / (1.0 + np.exp(-np.clip(Z @ self.w, -60.0, 60.0)))

    # ----------------------------------------------------- persistence
    def save(self, path: str) -> None:
        np.savez(path, w=self.w, mean=self.mean, std=self.std,
                 decays=np.asarray(self.decays, np.float64),
                 gamma=np.asarray(self.gamma, np.float64),
                 confidence=np.asarray(self.confidence, np.float64),
                 meta=np.frombuffer(
                     json.dumps(self.meta, sort_keys=True).encode(), np.uint8))

    @classmethod
    def load(cls, path: str) -> "LearnedModel":
        """Load a ``save``d checkpoint. A missing, truncated, corrupt,
        or wrong-shape file raises ``ModelLoadError`` (a ``ValueError``)
        naming the problem — callers that must not crash mid-serve use
        ``load_or_none`` and fall back (see ``LearnedPolicy``)."""
        try:
            z = np.load(path)
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            # missing file, not-an-npz blob, truncated archive
            raise ModelLoadError(f"cannot read model file {path!r}: {e}") \
                from e
        if not hasattr(z, "files"):  # a bare .npy array, not an .npz
            raise ModelLoadError(
                f"model file {path!r} is not an .npz archive")
        with z:
            missing = [k for k in ("w", "mean", "std", "decays", "gamma",
                                   "confidence") if k not in z]
            if missing:
                raise ModelLoadError(
                    f"model file {path!r} is missing arrays {missing} "
                    f"(truncated or not a LearnedModel checkpoint)")
            try:
                w, mean, std = z["w"], z["mean"], z["std"]
                decays = tuple(z["decays"])
                gamma = float(z["gamma"])
                confidence = float(z["confidence"])
                meta = json.loads(bytes(z["meta"].tobytes()).decode()) \
                    if "meta" in z else {}
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                # zlib CRC failures on corrupt members surface as
                # ValueError/BadZipFile during array decompression
                raise ModelLoadError(
                    f"model file {path!r} is corrupt: {e}") from e
            if w.shape != (N_FEATURES,) or mean.shape != (N_FEATURES,) \
                    or std.shape != (N_FEATURES,):
                raise ModelLoadError(
                    f"model file {path!r} has wrong shapes "
                    f"(w {w.shape}, mean {mean.shape}, std {std.shape}; "
                    f"expected ({N_FEATURES},))")
            return cls(w, mean, std, decays=decays, gamma=gamma,
                       confidence=confidence, meta=meta)

    @classmethod
    def load_or_none(cls, path: str) -> Optional["LearnedModel"]:
        """``load`` that returns None (after a warning) instead of
        raising — the serve-time entry point: a bad checkpoint degrades
        to the heuristic fallback, never crashes the server."""
        try:
            return cls.load(path)
        except ModelLoadError as e:
            warnings.warn(str(e), stacklevel=2)
            return None


# ---------------------------------------------------------------------
# dataset extraction from trace histories
# ---------------------------------------------------------------------
def _ordered_steps(trace) -> List:
    """Trace steps in decode order (the recorder appends in order)."""
    return list(trace.steps)


def extract_dataset(trace, num_experts: int, *,
                    decays: Sequence[float] = DECAYS, gamma: float = GAMMA
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n, N_FEATURES], y [n]) over every (step, layer, expert).

    The label for (token t, layer l, expert e) is "e activates at
    (t, l)"; the features are the layer's online state BEFORE t plus
    the same-token previous-layer transition row (``engine_step``
    aligns layers of one token pass; traces predating the field fall
    back to record adjacency)."""
    states: Dict[int, LayerState] = {}
    trans: Dict[int, np.ndarray] = {}   # layer -> [E, E] counts (l -> l+1)
    Xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    prev_step = None
    for s in _ordered_steps(trace):
        layer = s.layer
        st = states.get(layer)
        if st is None:
            st = states[layer] = LayerState(num_experts, decays=decays,
                                            gamma=gamma)
        # same-token previous-layer context
        ctx = None
        if prev_step is not None and prev_step.layer == layer - 1 and \
                (getattr(s, "engine_step", -1) < 0 or
                 getattr(prev_step, "engine_step", -1) < 0 or
                 prev_step.engine_step == s.engine_step):
            ctx = tuple(int(e) for e in prev_step.activated)
        row = None
        if ctx:
            C = trans.get(layer - 1)
            if C is not None:
                mass = C[list(ctx), :].sum(axis=0)
                tot = mass.sum()
                if tot > 0:
                    row = mass / tot
        X = st.features(row)
        y = np.zeros(num_experts, np.float64)
        acts = [int(e) for e in s.activated]
        if acts:
            y[acts] = 1.0
        Xs.append(X)
        ys.append(y)
        # causal updates AFTER emitting the sample
        st.observe(acts)
        if ctx:
            C = trans.get(layer - 1)
            if C is None:
                C = trans[layer - 1] = np.zeros(
                    (num_experts, num_experts), np.float64)
            for a in ctx:
                C[a, acts] += 1.0
        prev_step = s
    if not Xs:
        return (np.zeros((0, N_FEATURES), np.float64),
                np.zeros(0, np.float64))
    return np.concatenate(Xs, axis=0), np.concatenate(ys, axis=0)


# ---------------------------------------------------------------------
# deterministic offline training
# ---------------------------------------------------------------------
def train_model(X: np.ndarray, y: np.ndarray, *, lr: float = 0.5,
                iters: int = 300, decays: Sequence[float] = DECAYS,
                gamma: float = GAMMA, meta: Optional[dict] = None
                ) -> LearnedModel:
    """Full-batch gradient descent on class-weighted logistic loss.

    float64, zero init, fixed iteration count, no RNG — bitwise
    deterministic for a given (X, y) (test-enforced)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    n = len(y)
    assert n > 0, "empty training set"
    mean = np.nanmean(X, axis=0)
    mean[0] = 0.0                                    # keep the bias column
    std = np.nanstd(X, axis=0)
    std[0] = 1.0
    std = np.where(std < 1e-9, 1.0, std)
    Xf = np.where(np.isnan(X), mean, X)
    Z = (Xf - mean) / std
    n_pos = float(y.sum())
    n_neg = float(n - n_pos)
    # balance classes (k-of-E activation makes positives rare)
    sw = np.where(y > 0.5, n_neg / max(n_pos, 1.0), 1.0)
    sw = sw / sw.sum()
    w = np.zeros(Z.shape[1], np.float64)
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-np.clip(Z @ w, -60.0, 60.0)))
        grad = Z.T @ (sw * (p - y))
        w -= lr * grad
    p = 1.0 / (1.0 + np.exp(-np.clip(Z @ w, -60.0, 60.0)))
    conf = 0.0
    if n_pos > 0 and n_neg > 0:
        conf = float(p[y > 0.5].mean() - p[y <= 0.5].mean())
    return LearnedModel(w, mean, std, decays=decays, gamma=gamma,
                        confidence=conf, meta=meta)


def train_from_trace(trace, num_experts: int, *,
                     decays: Sequence[float] = DECAYS, gamma: float = GAMMA,
                     lr: float = 0.5, iters: int = 300,
                     meta: Optional[dict] = None) -> LearnedModel:
    """Offline training entry: TraceRecorder history -> LearnedModel."""
    X, y = extract_dataset(trace, num_experts, decays=decays, gamma=gamma)
    m = dict(meta or {})
    m.setdefault("num_experts", int(num_experts))
    m.setdefault("n_samples", int(len(y)))
    return train_model(X, y, lr=lr, iters=iters, decays=decays, gamma=gamma,
                       meta=m)


# ---------------------------------------------------------------------
# evaluation + synthetic traces
# ---------------------------------------------------------------------
def evaluate_recall(trace, num_experts: int, k: int,
                    model: Optional[LearnedModel] = None) -> float:
    """Mean recall@k of per-step activation prediction over a trace.

    Ranks experts by the model's reuse probability (or, when ``model``
    is None, by the running marginal frequency — the classical
    baseline the learned model must beat) from the same causal state
    walk as training, so the number is comparable across the two."""
    states: Dict[int, LayerState] = {}
    trans: Dict[int, np.ndarray] = {}
    prev_step = None
    hits = total = 0
    for s in _ordered_steps(trace):
        layer = s.layer
        st = states.get(layer)
        if st is None:
            st = states[layer] = LayerState(
                num_experts,
                decays=model.decays if model else DECAYS,
                gamma=model.gamma if model else GAMMA)
        ctx = None
        if prev_step is not None and prev_step.layer == layer - 1:
            ctx = tuple(int(e) for e in prev_step.activated)
        row = None
        if ctx:
            C = trans.get(layer - 1)
            if C is not None:
                mass = C[list(ctx), :].sum(axis=0)
                tot = mass.sum()
                if tot > 0:
                    row = mass / tot
        acts = [int(e) for e in s.activated]
        if acts and st.t > 0:                 # skip the cold first step
            if model is not None:
                score = model.predict(st.features(row))
            else:
                score = st.counts / max(st.t, 1)
            top = np.argsort(-score, kind="stable")[:k]
            hits += len(set(int(i) for i in top) & set(acts))
            total += min(len(acts), k)
        st.observe(acts)
        if ctx:
            C = trans.get(layer - 1)
            if C is None:
                C = trans[layer - 1] = np.zeros(
                    (num_experts, num_experts), np.float64)
            for a in ctx:
                C[a, acts] += 1.0
        prev_step = s
    return hits / total if total else 0.0


def synthetic_trace(acts_by_layer: Sequence[Sequence[Sequence[int]]]):
    """TraceRecorder from bare per-layer activation sequences
    (``acts_by_layer[layer][token] = expert ids``) — lets the calibrated
    ``ExpertWorkload``s train predictors without a model in the loop.
    Steps are recorded token-major (all layers of token t share one
    ``engine_step``), matching a real decode trace's order."""
    from repro_torch.core.trace import TraceRecorder

    tr = TraceRecorder()
    n_layers = len(acts_by_layer)
    n_tokens = min(len(a) for a in acts_by_layer) if n_layers else 0
    for t in range(n_tokens):
        for layer in range(n_layers):
            ids = tuple(int(e) for e in acts_by_layer[layer][t])
            tr.record(prompt_id=0, token_idx=t, layer=layer, activated=ids,
                      gate_weights=tuple(1.0 for _ in ids), cache_before=(),
                      cache_after=(), hits=(), misses=(), evicted=(),
                      engine_step=t)
    return tr

"""The port's learned expert-activation model (``repro_torch.core.learned``),
``LearnedPolicy`` and ``LearnedPredictor`` against the JAX package's on
the CPU. Training is float64 full-batch gradient descent in numpy, so
the same trace gives bitwise the same weights in both packages; a
checkpoint written by one loads in the other; the policy falls back to
AgedLFU victim for victim; bad checkpoints raise ``ModelLoadError`` or
degrade to the fallback. Engines and servers with ``policy="learned"`` /
``prefetch="learned"`` (overlap off and on) give the reference's tokens,
functional trace rows, ``stats()`` and simulated clock exactly. Weights
are the JAX package's, bridged by ``from_jax_params``; the shared
fixtures are ``test_torch_engine.py``'s."""
import contextlib
import zipfile

import numpy as np
import pytest

from repro.core import OffloadEngine as JEngine
from repro.core import cache_policies as jpol
from repro.core import learned as jl
from repro.core import prefetch as jpre
from repro.data import drifting_workload
from repro.serving import ContinuousOffloadServer as JServer
from repro.serving import OffloadServer as JOffloadServer
from repro_torch.core import cache_policies as ppol
from repro_torch.core import learned as pl
from repro_torch.core import prefetch as ppre
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.serving.offload_serving import (ContinuousOffloadServer,
                                                 OffloadServer)
from test_torch_engine import (PROMPTS, _assert_same_run,  # noqa: F401
                               _one_torch_thread, _rows, _track_margins,
                               setup)

E = 8


def drift_acts(seed, *, layers=2, tokens=64):
    return drifting_workload(num_layers=layers, num_experts=E, top_k=2,
                             n_tokens=tokens, seed=seed).acts


def assert_same_model(pm, jm):
    assert (pm.w == jm.w).all()
    assert (pm.mean == jm.mean).all()
    assert (pm.std == jm.std).all()
    assert pm.decays == jm.decays and pm.gamma == jm.gamma
    assert pm.confidence == jm.confidence and pm.meta == jm.meta


def replay(acts, make, cache):
    """Per-layer policy replay over ``acts[layer][token]``; returns (hit
    rate, victims in order)."""
    hits = total = 0
    victims = []
    pols = [make(cache) for _ in acts]
    for t in range(len(acts[0])):
        for layer, p in enumerate(pols):
            for e in acts[layer][t]:
                total += 1
                if p.contains(e):
                    hits += 1
                    p.on_access(e)
                else:
                    if p.full:
                        victims.append(p.choose_victim())
                        p.remove(victims[-1])
                    p.on_insert(e)
            p.tick()
    return hits / total, victims


# ------------------------------------------------------------ training
@pytest.mark.parametrize("seed,layers,tokens", [(3, 2, 64), (11, 4, 128),
                                                (5, 3, 32)])
def test_training_bitwise_equals_reference(seed, layers, tokens):
    acts = drift_acts(seed, layers=layers, tokens=tokens)
    pm = pl.train_from_trace(pl.synthetic_trace(acts), E)
    jm = jl.train_from_trace(jl.synthetic_trace(acts), E)
    assert_same_model(pm, jm)
    assert np.isfinite(pm.w).all()
    again = pl.train_from_trace(pl.synthetic_trace(acts), E)
    assert_same_model(again, pm)


def test_extract_dataset_shape_cold_features_and_reference():
    acts = drift_acts(5, layers=1, tokens=16)
    tr = pl.synthetic_trace(acts)
    X, y = pl.extract_dataset(tr, E)
    n_steps = len(tr.steps)
    assert X.shape == (n_steps * E, pl.N_FEATURES)
    assert y.shape == (n_steps * E,)
    first = X[:E]   # no history: bias 1, traces/freq/recency 0, NaN trans
    assert (first[:, 0] == 1.0).all()
    assert (first[:, 1:6] == 0.0).all()
    assert np.isnan(first[:, 6]).all()
    assert y[:E].sum() == len(tr.steps[0].activated)
    jX, jy = jl.extract_dataset(jl.synthetic_trace(acts), E)
    np.testing.assert_array_equal(X, jX)       # NaN == NaN here
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("writer,reader", [(jl, pl), (pl, jl), (pl, pl)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_npz_roundtrip_across_packages(tmp_path, writer, reader):
    acts = drift_acts(7)
    m = writer.train_from_trace(writer.synthetic_trace(acts), E,
                                meta={"arch": "test", "k": 2})
    path = str(tmp_path / "w.npz")
    m.save(path)
    got = reader.LearnedModel.load(path)
    assert_same_model(got, m)
    x = [1.0, 0.5, 0.5, 0.5, 0.25, 0.8, float("nan")]
    assert got.predict(x) == m.predict(x)


def test_trace_json_roundtrip_trains_identical_weights():
    tr = pl.synthetic_trace(drift_acts(11))
    back = type(tr).from_json(tr.to_json())
    assert back.steps == tr.steps
    assert_same_model(pl.train_from_trace(back, E),
                      pl.train_from_trace(tr, E))


@pytest.mark.parametrize("with_model", [False, True])
def test_evaluate_recall_equals_reference(with_model):
    pm = jm = None
    if with_model:
        acts = drift_acts(17, layers=4, tokens=128)
        pm = pl.train_from_trace(pl.synthetic_trace(acts), E)
        jm = jl.train_from_trace(jl.synthetic_trace(acts), E)
    ev = drift_acts(1017, layers=4, tokens=128)
    got = pl.evaluate_recall(pl.synthetic_trace(ev), E, 2, pm)
    assert got == jl.evaluate_recall(jl.synthetic_trace(ev), E, 2, jm)
    if with_model:
        assert got > pl.evaluate_recall(pl.synthetic_trace(ev), E, 2, None)


def test_layerstate_matches_extractor_walk():
    tr = pl.synthetic_trace(drift_acts(19, layers=1, tokens=24))
    X, _ = pl.extract_dataset(tr, E)
    st = pl.LayerState(E)
    for i, s in enumerate(tr.steps):
        np.testing.assert_array_equal(st.features(None)[:, :6],
                                      X[i * E:(i + 1) * E, :6])
        st.observe(s.activated)


# ------------------------------------------------------ LearnedPolicy
def _confident_model(lib, conf=0.9):
    """Hand-built model scoring by the fast trace (feature 1)."""
    w = np.zeros(lib.N_FEATURES)
    w[1] = 4.0
    return lib.LearnedModel(w, np.zeros(lib.N_FEATURES),
                            np.ones(lib.N_FEATURES), confidence=conf)


def test_learned_registered_and_usable_without_model():
    assert ppol.POLICIES["learned"] is ppol.LearnedPolicy
    p = ppol.make_policy("learned", 2)
    p.on_insert("a")
    p.on_insert("b")
    assert p.choose_victim() in ("a", "b")


def test_low_confidence_falls_back_to_agedlfu_victim_for_victim():
    rng = np.random.default_rng(0)
    keys = [[(int(k),) for k in rng.integers(0, 12, size=400)]]
    low = _confident_model(pl, conf=0.01)        # below min_confidence
    got = replay(keys, lambda c: ppol.LearnedPolicy(
        c, model=low, min_confidence=0.05), 4)
    assert got == replay(keys, ppol.AgedLFU, 4)
    assert got[1]                                # evictions happened
    assert got == replay(keys, lambda c: jpol.LearnedPolicy(
        c, model=_confident_model(jl, conf=0.01), min_confidence=0.05), 4)


def test_model_victim_is_least_predicted_reuse():
    p = ppol.LearnedPolicy(3, model=_confident_model(pl))
    for k, n in [("hot", 6), ("warm", 3), ("cold", 1)]:
        p.on_insert(k)
        for _ in range(n - 1):
            p.on_access(k)
        p.tick()
    assert p.choose_victim() == "cold"
    assert p.choose_victim(exclude=frozenset(["cold"])) == "warm"
    with pytest.raises(RuntimeError):
        p.choose_victim(exclude=frozenset(["hot", "warm", "cold"]))


def test_trained_policy_matches_reference_and_beats_lru_lfu():
    """Train on one drift workload, replay another: the port's victims
    equal the reference's, and learned beats recency-only AND
    popularity-only."""
    acts = drift_acts(17, layers=4, tokens=128)
    pm = pl.train_from_trace(pl.synthetic_trace(acts), E)
    jm = jl.train_from_trace(jl.synthetic_trace(acts), E)
    ev = drift_acts(1017, layers=4, tokens=128)
    got = replay(ev, lambda c: ppol.make_policy("learned", c, model=pm), 4)
    assert got == replay(
        ev, lambda c: jpol.make_policy("learned", c, model=jm), 4)
    for name in ("lru", "lfu"):
        assert got[0] > replay(ev, lambda c: ppol.make_policy(name, c), 4)[0]


def test_persistent_counts_contracts():
    p = ppol.LearnedPolicy(1, model=_confident_model(pl))
    p.on_insert("a")
    p.on_access("a")
    p.remove("a")
    assert p._cnt["a"] == 2 and "a" in p._traces
    q = ppol.LearnedPolicy(2, model=_confident_model(pl),
                           persistent_counts=False)
    for k in ("a", "b", "c", "d"):
        if q.full:
            q.remove(q.choose_victim())
        q.on_insert(k)
        q.tick()
    resident = set(q.keys())
    assert len(resident) == 2
    for d in (q._traces, q._trace_t, q._cnt, q._last_act, q._ffreq):
        assert set(d) <= resident


# --------------------------------------------------- ModelLoadError
def _bad_files(tmp_path):
    """name -> path of a file ``LearnedModel.load`` must refuse."""
    good = tmp_path / "good.npz"
    pl.LearnedModel(np.zeros(7), np.zeros(7), np.ones(7)).save(str(good))
    (tmp_path / "garbage.npz").write_bytes(b"this is not an npz file")
    (tmp_path / "trunc.npz").write_bytes(good.read_bytes()[:40])
    with zipfile.ZipFile(tmp_path / "wrong.npz", "w") as z:
        z.writestr("unrelated.npy", b"x")
    np.savez(tmp_path / "shape.npz", w=np.zeros(3), mean=np.zeros(3),
             std=np.ones(3), decays=np.zeros(3), gamma=np.float64(0.8),
             confidence=np.float64(0.5))
    return {n: str(tmp_path / f"{n}.npz")
            for n in ("nope", "garbage", "trunc", "wrong", "shape")}


@pytest.mark.parametrize("name", ["nope", "garbage", "trunc", "wrong",
                                  "shape"])
def test_load_rejects_bad_files_like_reference(tmp_path, name):
    path = _bad_files(tmp_path)[name]
    with pytest.raises(pl.ModelLoadError) as err:
        pl.LearnedModel.load(path)
    assert isinstance(err.value, ValueError)
    with pytest.raises(jl.ModelLoadError):
        jl.LearnedModel.load(path)
    with pytest.warns(UserWarning):
        assert pl.LearnedModel.load_or_none(path) is None


def test_policy_falls_back_on_bad_checkpoint(setup, tmp_path):
    """A checkpoint path that does not load warns and gives the exact
    AgedLFU fallback, in the policy and through the engine."""
    bad = str(tmp_path / "nope.npz")
    with pytest.warns(UserWarning):
        pol = ppol.LearnedPolicy(3, model=bad)
    ref = ppol.AgedLFU(3)
    for p in (pol, ref):
        for e in (0, 1, 2):
            p.on_insert(e)
        for e in (0, 1, 2, 0, 0, 1):
            p.on_access(e)
            p.tick()
    assert pol.choose_victim() == ref.choose_victim()
    _, _, pc, tp = setup
    runs = []
    for kw in (dict(policy="learned", policy_kw={"model": bad}),
               dict(policy="aged-lfu")):
        with pytest.warns(UserWarning) if "policy_kw" in kw else \
                contextlib.nullcontext():
            eng = OffloadEngine(tp, pc, cache_slots=3, device="cpu", **kw)
        runs.append((eng.generate(PROMPTS[0], 6), _rows(eng.trace),
                     eng.stats()))
    assert runs[0] == runs[1]


# ---------------------------------------------------- LearnedPredictor
@pytest.mark.parametrize("with_model", [False, True])
def test_predictor_matches_reference_and_follows_transitions(with_model):
    """Layer 1 re-activates layer 0's expert: the port's guesses equal
    the reference's step for step and follow the coupling (Markov
    ranking without a model)."""
    rng = np.random.default_rng(2)
    seq = [int(e) for e in rng.integers(0, 6, size=160)]
    acts = [[(e,) for e in seq], [(e,) for e in seq]]
    pm = pl.train_from_trace(pl.synthetic_trace(acts), 6) \
        if with_model else None
    jm = jl.train_from_trace(jl.synthetic_trace(acts), 6) \
        if with_model else None
    preds = (ppre.LearnedPredictor(2, 6, 1, pm),
             jpre.LearnedPredictor(2, 6, 1, jm))
    hits = total = 0
    for t, e in enumerate(seq):
        guesses = []
        for pred in preds:
            pred.observe(0, (e,))
            guesses.append(pred.predict(0, (e,)))
            pred.update(0, (e,), (e,))
            pred.observe(1, (e,))
        assert guesses[0] == guesses[1]
        if t > 8:
            hits += int(guesses[0] == (e,))
            total += 1
    assert hits / total > 0.9
    assert preds[0].predict(1, (0,)) == ()       # no layer 2
    assert preds[0].predict(0, ()) == ()


# ------------------------------------------------ engine and servers
@pytest.fixture(scope="module")
def engine_models(setup):
    """(JAX model, port model), each trained from its own package's
    profiling run (every expert resident): the two traces' functional
    rows are equal, so the weights are bitwise equal."""
    cfg, jp, pc, tp = setup
    jeng = JEngine(jp, cfg, cache_slots=E, policy="lru")
    peng = OffloadEngine(tp, pc, cache_slots=E, policy="lru", device="cpu")
    jeng.generate([1, 2, 3, 4], 8)
    peng.generate([1, 2, 3, 4], 8)
    assert _rows(peng.trace) == _rows(jeng.trace)
    jm = jl.train_from_trace(jeng.trace, E)
    pm = pl.train_from_trace(peng.trace, E)
    assert_same_model(pm, jm)
    return jm, pm


ENGINE_CASES = [dict(policy="learned", model=True),
                dict(policy="learned", model=False),   # AgedLFU path
                dict(policy="learned", model="path"),  # a saved checkpoint
                dict(policy="lru", prefetch="learned", model=True),
                dict(policy="learned", prefetch="learned", model=True)]


def _engine_kwargs(case, models, tmp_path):
    """(JAX kwargs, port kwargs) for one ENGINE_CASES entry."""
    kw = {k: v for k, v in case.items() if k != "model"}
    if case["model"] == "path":
        path = str(tmp_path / "w.npz")
        models[1].save(path)
        pkw = dict(kw, policy_kw={"model": path})
        return dict(kw, policy_kw={"model": path}), pkw
    if case["model"]:
        return dict(kw, learned_model=models[0]), \
            dict(kw, learned_model=models[1])
    return kw, kw


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("case", ENGINE_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_engine_learned_matches_reference(setup, engine_models, tmp_path,
                                          case, overlap):
    cfg, jp, pc, tp = setup
    jkw, pkw = _engine_kwargs(case, engine_models, tmp_path)
    jeng = JEngine(jp, cfg, cache_slots=4, overlap=overlap, **jkw)
    peng = OffloadEngine(tp, pc, cache_slots=4, overlap=overlap,
                         device="cpu", **pkw)
    margins = _track_margins(peng)
    assert peng.generate(PROMPTS[2], 8) == jeng.generate(PROMPTS[2], 8)
    _assert_same_run(jeng, peng, margins)
    s = peng.stats()
    assert s["misses"] > 0 and (s["prefetches"] > 0) == \
        (case.get("prefetch") == "learned")


@pytest.mark.parametrize("overlap", [False, True])
def test_continuous_server_learned_matches_reference(setup, engine_models,
                                                     overlap):
    cfg, jp, pc, tp = setup
    jm, pm = engine_models
    skw = dict(cache_slots=3, max_batch=2, cache_len=32, kv_block_size=8,
               policy="learned", prefetch="learned", overlap=overlap)
    jsrv = JServer(jp, cfg, learned_model=jm, **skw)
    psrv = ContinuousOffloadServer(tp, pc, learned_model=pm, device="cpu",
                                   **skw)
    margins = _track_margins(psrv.engine)
    for srv in (jsrv, psrv):
        for p in PROMPTS:
            srv.submit(p, max_new=5)
    assert psrv.run() == jsrv.run()
    assert psrv.stats() == jsrv.stats()
    _assert_same_run(jsrv.engine, psrv.engine, margins)


def test_offload_server_facade_learned_matches_reference(setup,
                                                         engine_models):
    cfg, jp, pc, tp = setup
    jm, pm = engine_models
    jsrv = JOffloadServer(jp, cfg, cache_slots=3, policy="learned",
                          prefetch="learned", learned_model=jm)
    psrv = OffloadServer(tp, pc, cache_slots=3, policy="learned",
                         prefetch="learned", learned_model=pm, device="cpu")
    margins = _track_margins(psrv.engine)
    for p in PROMPTS:
        assert psrv.complete(p, max_new=4) == jsrv.complete(p, max_new=4)
    assert psrv.stats() == jsrv.stats()
    _assert_same_run(jsrv.engine, psrv.engine, margins)

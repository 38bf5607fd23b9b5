"""The port's on-device ``ServingEngine`` against the JAX package's, on
shared weights (JAX init, bridged): greedy tokens must be EQUAL for a
tiny Mixtral, Qwen2.5 and Mamba2, and for Mixtral through a sliding
window ring cache. Routing decides Mixtral's tokens, so those tests
assert the smallest router top-k margin they saw (``torch.topk`` and
``jax.lax.top_k`` may order a tie differently). Then the engine's own
behaviour: sampling at temperature > 0 is a function of (seed, step),
EOS stops a row, and it refuses params on another device."""
import pytest

from repro.serving import ServingEngine as JEngine
from repro_torch.serving.engine import ServingEngine
from test_torch_prefill import (MIN_MARGIN, _model,  # noqa: F401
                                _one_torch_thread, track_margins)

PROMPTS = [[3, 17, 42, 5, 99, 7], [9, 8, 7], [1, 2, 3, 4, 5]]


@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x7b", {}),
    ("qwen2.5-3b", {}),
    ("mamba2-2.7b", {}),
    ("mixtral-8x7b", dict(window=4)),   # ring of 4 slots, 12 positions
], ids=["mixtral", "qwen", "mamba2", "mixtral-window"])
def test_greedy_tokens_equal_reference(arch, kw, monkeypatch):
    cfg, jp, tp = _model(arch)
    cache_len = kw.get("window", 16)
    margins = track_margins(monkeypatch)
    want = JEngine(jp, cfg, cache_len=cache_len, **kw).generate_batch(
        PROMPTS, max_new=6)
    got = ServingEngine(tp, cfg, cache_len=cache_len, device="cpu",
                        **kw).generate_batch(PROMPTS, max_new=6)
    assert got == want
    if cfg.is_moe:
        assert min(margins) > MIN_MARGIN, min(margins)


def test_sampling_is_a_function_of_seed_and_step():
    cfg, _, tp = _model("qwen2.5-3b")
    eng = ServingEngine(tp, cfg, cache_len=16, device="cpu")
    kw = dict(max_new=6, temperature=1.0, top_p=0.9)
    a = eng.generate_batch(PROMPTS, seed=5, **kw)
    assert eng.generate_batch(PROMPTS, seed=5, **kw) == a
    assert all(len(r) == 6 for r in a)
    others = [eng.generate_batch(PROMPTS, seed=s, **kw) for s in (6, 7)]
    assert any(o != a for o in others)


def test_eos_stops_a_row_and_device_mismatch_raises():
    cfg, jp, tp = _model("mamba2-2.7b")
    greedy = ServingEngine(tp, cfg, device="cpu").generate_batch(
        PROMPTS[:2], max_new=6)
    eos = greedy[0][2]
    got = ServingEngine(tp, cfg, eos_id=eos, device="cpu").generate_batch(
        PROMPTS[:2], max_new=6)
    want = JEngine(jp, cfg, eos_id=eos).generate_batch(PROMPTS[:2],
                                                       max_new=6)
    assert got == want and got[0] == greedy[0][:greedy[0].index(eos) + 1]
    with pytest.raises(ValueError):
        ServingEngine(tp, cfg, device="meta")

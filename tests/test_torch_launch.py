"""The port's launch CLIs and example scripts on the CPU: the twin of
``tests/test_launch_clis.py`` (subprocesses of ``python -m
repro_torch.launch.train|serve`` with ``--device cpu``), the
checkpoint a port CLI writes loaded by the JAX package, the CLIs'
tokens against the port's library called in-process with the same
seed, the refusals with the JAX CLIs' messages, no start on a CUDA
device that is not there, and the greedy parts of ``quickstart`` and
``serve_batch`` against the JAX package on bridged weights."""
import ast
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import serve as jserve_cli
from repro.launch import train as jtrain_cli
from repro.models import transformer as jtf
from repro.serving import ContinuousOffloadServer as JServer
from repro.serving import OffloadServer as JOffloadServer
from repro.training import load_checkpoint as jload
import repro_torch.configs as pcfg
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.examples import quickstart, serve_batch
from repro_torch.examples.offload_paper_pipeline import pipeline_config
from repro_torch.models import transformer as ptf
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.offload_serving import OffloadServer
from repro_torch.training import load_checkpoint
from repro_torch.training.tree import flatten
from test_torch_engine import MIN_MARGIN, _track_margins

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PROMPT = [1, 2, 3, 4, 5, 6, 7, 8]   # the serve CLI's prompt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than a pool, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(args, *, env=None, timeout=300):
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    return subprocess.run([sys.executable, "-m"] + args, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _tokens(stdout):
    return [ast.literal_eval(line.split("tokens:", 1)[1].strip())
            for line in stdout.splitlines() if line.startswith("tokens:")]


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {k: v.numpy() for k, v in flatten(tree)}


# ---------------------------------------------------------------- train
def test_train_cli_checkpoint_loads_in_jax(tmp_path):
    ck = os.path.join(tmp_path, "ck.npz")
    r = _run(["repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
              "--reduced", "--steps", "3", "--batch", "2", "--seq", "32",
              "--ckpt", ck, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    last = [l for l in r.stdout.splitlines() if l.startswith("final loss")]
    assert len(last) == 1 and "(start " in last[0]
    assert f"saved {ck}" in r.stdout
    # the CLI's reduced config, in both packages
    jcfg = dataclasses.replace(jreduced(jget_config("qwen1.5-0.5b"),
                                        layers=2, d_model=256, vocab=512),
                               dtype="float32")
    pc = dataclasses.replace(pcfg.reduced(pcfg.get_config("qwen1.5-0.5b"),
                                          layers=2, d_model=256, vocab=512),
                             dtype="float32")
    assert dataclasses.asdict(pc) == dataclasses.asdict(jcfg)
    jtree, jstep = jload(ck, jtf.init_params(jcfg, jax.random.PRNGKey(1)))
    ptree, pstep = load_checkpoint(
        ck, ptf.init_params(pc, torch.Generator().manual_seed(1),
                            device="cpu"))
    assert jstep == pstep == 3
    want = _flat_jax(jtree)
    got = _flat_jax(ptf.to_jax_params(ptree))
    assert want.keys() == got.keys() == _flat_port(ptree).keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    # trained: the embedding is no longer the init's
    init = ptf.init_params(pc, torch.Generator().manual_seed(0),
                           device="cpu")
    assert not torch.equal(ptree["embed"], init["embed"])


# ---------------------------------------------------------------- serve
def _port_params(arch, layers, d_model, seed=0):
    cfg = dataclasses.replace(pcfg.reduced(pcfg.get_config(arch),
                                           layers=layers, d_model=d_model),
                              dtype="float32")
    return cfg, ptf.init_params(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")


def test_serve_cli_offload_equals_library():
    r = _run(["repro_torch.launch.serve", "--arch", "mixtral-8x7b",
              "--policy", "lfu", "--cache-slots", "4", "--tokens", "4",
              "--layers", "2", "--d-model", "64", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "hit_rate" in r.stdout
    assert "layer 1  ('#'=hit 'O'=miss '.'=miscached)" in r.stdout
    cfg, params = _port_params("mixtral-8x7b", 2, 64)
    srv = OffloadServer(params, cfg, cache_slots=4, policy="lfu",
                        device="cpu")
    want = srv.complete(PROMPT, max_new=4)
    assert _tokens(r.stdout) == [want]
    hit = [l.split() for l in r.stdout.splitlines()
           if l.split()[:1] == ["hit_rate"]]
    assert float(hit[0][1]) == srv.stats()["hit_rate"]


def test_serve_cli_device_mode_equals_library():
    r = _run(["repro_torch.launch.serve", "--arch", "qwen2.5-3b",
              "--mode", "device", "--tokens", "4", "--layers", "2",
              "--d-model", "64", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    cfg, params = _port_params("qwen2.5-3b", 2, 64)
    eng = ServingEngine(params, cfg, cache_len=len(PROMPT) + 4,
                        device="cpu")
    want = eng.generate_batch([PROMPT, PROMPT[::-1]], max_new=4)
    assert _tokens(r.stdout) == want


# ------------------------------------------------------------ refusals
def _jax_exit(module, argv, monkeypatch):
    """The message of the SystemExit the JAX CLI ``module`` raises."""
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    with pytest.raises(SystemExit) as e:
        module.main()
    return str(e.value.code)


@pytest.mark.parametrize("cli, argv", [
    ("train", ["--arch", "whisper-tiny"]),
    ("train", ["--arch", "llama-3.2-vision-11b", "--reduced"]),
    ("serve", ["--arch", "qwen2.5-3b", "--layers", "2", "--d-model", "64"]),
])
def test_cli_refusals_carry_jax_messages(cli, argv, monkeypatch):
    r = _run([f"repro_torch.launch.{cli}", *argv, "--device", "cpu"])
    assert r.returncode == 1
    module = jtrain_cli if cli == "train" else jserve_cli
    want = _jax_exit(module, argv, monkeypatch)
    assert want and r.stderr.strip().splitlines()[-1] == want


@pytest.mark.parametrize("module, argv", [
    ("repro_torch.launch.train", ["--arch", "qwen1.5-0.5b", "--reduced",
                                  "--steps", "1"]),
    ("repro_torch.launch.serve", ["--tokens", "1"]),
    ("repro_torch.examples.quickstart", []),
    ("repro_torch.examples.serve_batch", []),
    ("repro_torch.examples.offload_paper_pipeline", []),
])
def test_entry_points_need_a_gpu_without_device_cpu(module, argv):
    """Without ``--device`` an entry point runs on ``cuda``: with no card
    visible it exits non-zero before it trains or serves anything."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run([module, *argv], env=env, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert "tokens:" not in r.stdout and "loss" not in r.stdout


# ------------------------------------------------------------ examples
def _bridge(jcfg, key):
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(key))
    return jp, ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture
def margins(monkeypatch):
    """Every port engine built in the test records its smallest router
    top-k margin a MoE call; the test asserts they stay far above fp32
    noise, so an unequal token would be a fault, not a near-tie."""
    seen = []
    orig = OffloadEngine.__init__

    def tracked(self, *a, **kw):
        orig(self, *a, **kw)
        seen.append(_track_margins(self))
    monkeypatch.setattr(OffloadEngine, "__init__", tracked)
    yield seen
    assert seen and min(min(m) for m in seen) > MIN_MARGIN


def test_quickstart_serving_equals_jax(margins):
    """quickstart's model (4 layers, d_model 128, 8 experts top-2, vocab
    256) on JAX's init: its LRU and LFU servers' tokens and ``stats()``
    equal JAX's ``OffloadServer``, and each other's tokens."""
    pc = pipeline_config()
    jcfg = dataclasses.replace(
        jreduced(jget_config("mixtral-8x7b"), layers=4, d_model=128,
                 experts=8, vocab=256),
        dtype="float32", num_experts_per_tok=2)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jcfg)
    jp, tp = _bridge(jcfg, 0)
    prompt, new = quickstart.PROMPT, 24
    got = quickstart.serve_policies(tp, pc, prompt, new, 4, device="cpu")
    for policy in ("lru", "lfu"):
        srv = JOffloadServer(jp, jcfg, cache_slots=4, policy=policy)
        assert got[policy]["tokens"] == srv.complete(prompt, max_new=new)
        assert got[policy]["stats"] == srv.stats()
    assert got["lru"]["tokens"] == got["lfu"]["tokens"]


def test_serve_batch_greedy_parts_equal_jax(margins):
    """serve_batch's MoE model on JAX's init (key 1): the solo offload
    server's and the continuous-batching server's tokens and ``stats()``
    equal JAX's, and continuous == solo. The dense engine samples (the
    packages agree there only in distribution): it runs, and repeats
    itself under the same seed."""
    cfg_d, pc = serve_batch.configs()
    jcfg = dataclasses.replace(
        jreduced(jget_config("mixtral-8x7b"), layers=3, d_model=128,
                 experts=8),
        dtype="float32", num_experts_per_tok=2)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jcfg)
    jp, tp = _bridge(jcfg, 1)
    prompts, new = serve_batch.PROMPTS, serve_batch.NEW

    solo = serve_batch.offload_solo(tp, pc, prompts, new, device="cpu")
    jsrv = JOffloadServer(jp, jcfg, cache_slots=4, policy="lfu",
                          prefetch="spec", overlap=True)
    assert solo["outs"] == [jsrv.complete(p, max_new=new,
                                          temperature=0.0)[len(p):]
                            for p in prompts]
    assert solo["stats"] == jsrv.stats()

    cont = serve_batch.continuous(tp, pc, prompts, new, device="cpu")
    jc = JServer(jp, jcfg, cache_slots=4, policy="lfu", prefetch="spec",
                 overlap=True, max_batch=2, cache_len=32)
    rids = [jc.submit(p, max_new=new) for p in prompts]
    jc.run()
    assert cont["outs"] == [jc.result(r)[len(p):]
                            for p, r in zip(prompts, rids)]
    assert cont["stats"] == jc.stats()
    assert cont["outs"] == solo["outs"]

    params_d = ptf.init_params(cfg_d, torch.Generator().manual_seed(0),
                               device="cpu")
    dense = serve_batch.dense_batch(params_d, cfg_d, prompts, new,
                                    device="cpu")
    assert [len(o) for o in dense] == [new] * len(prompts)
    assert dense == serve_batch.dense_batch(params_d, cfg_d, prompts, new,
                                            device="cpu")

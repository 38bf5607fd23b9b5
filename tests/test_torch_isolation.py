"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, its configs mirror the reference's field for field,
its params bridge to and from the JAX package's bit for bit, and
``chip_smoke.py`` refuses to run without a GPU or outside the repo."""
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.models import transformer as jtf
import repro_torch.configs as pcfg
from repro_torch.models import transformer as ptf

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)",
                       re.MULTILINE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than a pool, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ptiny(**kw):
    """The port's twin of ``conftest.tiny('mixtral-8x7b')``."""
    defaults = dict(layers=2, d_model=64, experts=4, vocab=128)
    defaults.update(kw)
    cfg = pcfg.reduced(pcfg.get_config("mixtral-8x7b"), **defaults)
    return dataclasses.replace(cfg, dtype="float32")


# ------------------------------------------------------------- imports
def test_port_sources_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in IMPORT_RE.finditer(f.read_text())]
    assert bad == []


def test_port_import_pulls_in_no_jax():
    code = ("import sys; sys.path.insert(0, 'src'); import repro_torch, "
            "repro_torch.core, repro_torch.serving.offload_serving, "
            "repro_torch.serving.engine, repro_torch.models.ssm, "
            "repro_torch.models.transformer, repro_torch.kernels.ops, "
            "repro_torch.training, repro_torch.data, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.models.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.specs, repro_torch.launch.op_cost, "
            "repro_torch.launch.dryrun, repro_torch.configs.all_configs, "
            "repro_torch.examples.offload_paper_pipeline; "
            "bad = [m for m in sys.modules if m == 'repro' or "
            "m.startswith(('jax', 'repro.'))]; "
            # the dry run's fake process group is imported where it opens
            "bad += [m for m in sys.modules if m.startswith("
            "'torch.testing._internal.distributed')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_calls_no_library_kernel():
    """The port's kernels are its own: no module calls PyTorch's fused
    attention (``chip_smoke.py`` times it only as a yardstick), and no
    CUDA source or shared header pulls in cuBLAS or cuDNN."""
    py = [f for f in PORT.rglob("*.py")
          if "scaled_dot_product_attention" in f.read_text()]
    assert py == []
    cu = sorted((PORT / "kernels" / "csrc").glob("*.cu"))
    assert {f.stem for f in cu} == {"moe_gemm", "paged_attention",
                                    "flash_attention", "flash_attention_bwd",
                                    "ssd_chunk", "ssd_chunk_bwd"}
    cuh = sorted((PORT / "kernels" / "csrc").glob("*.cuh"))
    bad = [f.name for f in cu + cuh
           if re.search(r"#include\s*<(cublas|cudnn)", f.read_text())]
    assert bad == []


@pytest.mark.parametrize("package", ["training", "data"])
def test_training_and_data_stand_alone(package):
    """The trainer and the data pipeline are the port's own copies: no
    source of theirs imports JAX or the JAX package, and importing them
    alone pulls in neither."""
    files = sorted((PORT / package).glob("*.py"))
    assert len(files) >= 2
    assert [f.name for f in files
            if IMPORT_RE.search(f.read_text())] == []
    code = (f"import sys; sys.path.insert(0, 'src'); "
            f"import repro_torch.{package}; "
            "bad = [m for m in sys.modules if m == 'repro' or "
            "m.startswith(('jax', 'repro.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# ------------------------------------------------------------- configs
def test_configs_mirror_reference_field_for_field():
    from repro.configs import get_config, list_archs
    from repro.configs.all_configs import ASSIGNED
    from repro_torch.configs.all_configs import ASSIGNED as PORT_ASSIGNED
    assert PORT_ASSIGNED == ASSIGNED and len(ASSIGNED) == 10
    assert set(ASSIGNED) <= set(pcfg.list_archs())
    want = dataclasses.asdict(get_config("mixtral-8x7b"))
    assert dataclasses.asdict(pcfg.get_config("mixtral-8x7b")) == want
    assert dataclasses.asdict(ptiny()) == dataclasses.asdict(
        tiny("mixtral-8x7b"))
    assert pcfg.list_archs() == list_archs()
    assert len(pcfg.list_archs()) == 11


# the data-only configs of families the port runs (dense, moe) ride along
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-2.7b",
                                  "deepseek-v2-236b", "qwen1.5-0.5b",
                                  "qwen1.5-32b", "starcoder2-3b",
                                  "llama4-scout-17b-a16e",
                                  "jamba-1.5-large-398b", "whisper-tiny",
                                  "llama-3.2-vision-11b"])
def test_new_configs_mirror_reference_field_for_field(arch):
    from repro.configs import get_config, reduced
    assert dataclasses.asdict(pcfg.get_config(arch)) == dataclasses.asdict(
        get_config(arch))
    assert dataclasses.asdict(pcfg.reduced(pcfg.get_config(arch))) == \
        dataclasses.asdict(reduced(get_config(arch)))


# -------------------------------------------------------------- bridge
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_bridge_roundtrip_is_bitwise():
    cfg = tiny("mixtral-8x7b")
    npt = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(0)))
    tp = ptf.from_jax_params(npt, device="cpu")
    back = ptf.to_jax_params(tp)
    a, b = dict(_leaves(npt)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    # stacked layouts at the port's public surface
    e = tp["layers"]["moe"]["experts"]
    assert tuple(e["w1"].shape) == (cfg.num_layers, cfg.num_experts,
                                    cfg.d_model, cfg.expert_d_ff)
    assert tuple(e["w2"].shape) == (cfg.num_layers, cfg.num_experts,
                                    cfg.expert_d_ff, cfg.d_model)


FAMILY_ARCHS = ["qwen2.5-3b", "mamba2-2.7b", "deepseek-v2-236b",
                "jamba-1.5-large-398b", "whisper-tiny", "llama-3.2-vision-11b"]
# leaves that only each of these archs' trees hold: the dense family's
# SwiGLU with QKV biases, the ssm family's mixer, MLA and the shared
# expert, the hybrid's attention and SSM stacks (a tuple of one per
# position of the period), the encdec's encoder and biased cross-attention
# and GELU MLP, the vlm's cross layers
DISTINCT = {
    "qwen2.5-3b": {"/layers/mlp/w3", "/layers/attn/bq"},
    "mamba2-2.7b": {"/layers/ssm/A_log"},
    "deepseek-v2-236b": {f"/layers/attn/{n}" for n in (
        "wq", "w_dkv", "w_kr", "latent_norm", "w_kb", "w_vb", "wo")}
    | {"/layers/moe/shared/w1"},
    "jamba-1.5-large-398b": {"/attn_layers/attn/wq",
                             "/ssm_layers/0/ssm/A_log",
                             "/ssm_layers/0/moe/experts/w1"},
    "whisper-tiny": {"/enc_layers/attn/bq", "/enc_norm", "/layers/cross/bk",
                     "/layers/mlp/b1"},
    "llama-3.2-vision-11b": {"/cross_layers/cross/wq", "/cross_layers/ln_c",
                             "/layers/mlp/w3"},
}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dense_and_ssm_bridge_roundtrip_is_bitwise(arch):
    """The dense family's ``mlp`` (and QKV biases, tied embeddings), the
    ssm family's ``ssm`` params, DeepSeek-V2's MLA attention and shared
    expert, and the hybrid, encdec and vlm trees (tuples, [P, per]
    stacks, cross-attention, GELU MLPs) survive the round trip bit for
    bit; ``A_log``, ``D`` and ``dt_bias`` stay fp32 even in a bf16 model,
    and so does the router."""
    cfg = tiny(arch)
    npt = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(3)))
    tp = ptf.from_jax_params(npt, device="cpu")
    back = ptf.to_jax_params(tp)
    a, b = dict(_leaves(npt)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    for other, keys in DISTINCT.items():
        assert (keys <= a.keys()) == (other == arch), other
    if arch == "jamba-1.5-large-398b":
        assert isinstance(tp["ssm_layers"], tuple)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    tb = ptf.from_jax_params(jax.tree.map(
        np.asarray, jtf.init_params(bf, jax.random.PRNGKey(3))), device="cpu")
    if arch in ("mamba2-2.7b", "jamba-1.5-large-398b"):
        ssm = (tb["layers"] if arch == "mamba2-2.7b"
               else tb["ssm_layers"][0])["ssm"]
        assert {ssm[n].dtype for n in ("A_log", "D", "dt_bias")} == {
            torch.float32}
        assert ssm["in_z"].dtype == torch.bfloat16
        if arch != "mamba2-2.7b":
            assert tb["ssm_layers"][0]["moe"]["router"].dtype == \
                torch.float32
    elif arch == "deepseek-v2-236b":
        assert tb["layers"]["moe"]["router"].dtype == torch.float32
        assert {t.dtype for t in tb["layers"]["attn"].values()} | {
            tb["layers"]["moe"]["shared"]["w2"].dtype} == {torch.bfloat16}
    elif arch == "whisper-tiny":
        assert {t.dtype for t in tb["layers"]["cross"].values()} | {
            tb["enc_layers"]["mlp"]["b1"].dtype} == {torch.bfloat16}
    else:
        assert tb["layers"]["mlp"]["w1"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_port_init_matches_reference_tree_for_dense_and_ssm(arch):
    """The port's own init draws the JAX package's tree, shapes, dtypes
    and (within sampling noise) scales for the other families, and for
    DeepSeek-V2's MLA attention and shared expert."""
    cfg = tiny(arch, d_model=96)
    jp = dict(_leaves(jax.tree.map(np.asarray,
                                   jtf.init_params(cfg, jax.random.PRNGKey(0)))))
    pc = dataclasses.replace(pcfg.reduced(pcfg.get_config(arch), layers=2,
                                          d_model=96, experts=4, vocab=128),
                             dtype="float32")
    pp = dict(_leaves(ptf.to_jax_params(
        ptf.init_params(pc, torch.Generator().manual_seed(0), device="cpu"))))
    assert jp.keys() == pp.keys()
    # the per-head SSM vectors are too short for a std: check their
    # supports (A = -exp(A_log) in [-16, -1], softplus(dt_bias) in
    # [1e-3, 1e-1], D = 1)
    ranges = {"/ssm/A_log": (0.0, np.log(16.0)),
              "/ssm/dt_bias": (np.log(np.expm1(1e-3)),
                               np.log(np.expm1(1e-1))),
              "/ssm/D": (1.0, 1.0)}
    for k in jp:
        assert jp[k].shape == pp[k].shape and jp[k].dtype == pp[k].dtype, k
        suffix = k[k.rfind("/ssm/"):] if "/ssm/" in k else None
        if suffix in ranges:
            lo, hi = ranges[suffix]
            assert lo - 1e-5 <= pp[k].min() and pp[k].max() <= hi + 1e-5, k
            continue
        sj, sp = float(jp[k].std()), float(pp[k].std())
        assert sp == pytest.approx(sj, rel=0.2, abs=1e-7), k


def test_port_init_matches_reference_tree_and_scales():
    cfg = tiny("mixtral-8x7b", d_model=96)
    jp = dict(_leaves(jax.tree.map(np.asarray,
                                   jtf.init_params(cfg, jax.random.PRNGKey(0)))))
    gen = torch.Generator().manual_seed(0)
    pp = dict(_leaves(ptf.to_jax_params(
        ptf.init_params(ptiny(d_model=96), gen, device="cpu"))))
    assert jp.keys() == pp.keys()
    for k in jp:
        assert jp[k].shape == pp[k].shape and jp[k].dtype == pp[k].dtype, k
        sj, sp = float(jp[k].std()), float(pp[k].std())
        assert sp == pytest.approx(sj, rel=0.15, abs=1e-7), k
    # a seeded generator reproduces its draws
    again = ptf.init_params(ptiny(d_model=96),
                            torch.Generator().manual_seed(0), device="cpu")
    np.testing.assert_array_equal(again["embed"].numpy(), pp["/embed"])

"""One rank of a distributed check of the port (no JAX here):

    python tests/_torch_dist_ranks.py CASE.json RANK WORLD

``tests/test_torch_distributed.py`` (and the other
``tests/test_torch_distributed_*.py``) start WORLD of these. Each opens a
gloo process group through the case's ``file://`` store, builds the
case's CPU mesh (its "axes", ("data", "model") by default), cuts the
whole inputs (``torch.save``d by the test) to its slices and runs the
sharded entry point. Every rank writes what it computed to
``out-RANK.pt`` beside the case file: the
entry points return whole outputs, so the test reads rank 0's and checks
that the ranks agree.
"""
import dataclasses
import json
import sys
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.mesh import make_mesh, sharding_rules  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402
from repro_torch.launch.specs import shard_decode_state  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training import (AdamWConfig, global_norm,  # noqa: E402
                                  init_opt_state, make_train_step)
from repro_torch.training import train_loop  # noqa: E402


def case_config(case):
    cfg = reduced(get_config(case["arch"]), **case["reduce"])
    return dataclasses.replace(cfg, **case["replace"])


def run_moe(case, cfg, mesh, rules, inp):
    """EP against the whole-batch paths: ``moe_ep_shardmap``, then
    ``moe_capacity`` / ``moe_dense`` / ``moe_gather`` with the experts
    split as the rules say and with them split over ff ("tp"), and each
    rank's own dispatch (its kept slots)."""
    p, x = inp["params"], inp["x"]
    out = {}
    for mode in ("ep", "tp"):
        r = dict(rules, experts_mode=mode)
        local = shd.shard_params(p, mesh, r)
        with shd.sharding_ctx(mesh, r):
            rows = shd.batch_rows(x)
            paths = {"capacity": moe_lib.moe_capacity,
                     "dense": moe_lib.moe_dense, "gather": moe_lib.moe_gather}
            if mode == "ep":
                paths["ep"] = moe_lib.moe_ep_shardmap
            for name, fn in paths.items():
                kw = ({"capacity_factor": case["cf"]}
                      if name in ("ep", "capacity") else {})
                y, aux = fn(local, cfg, rows, **kw)
                out[f"{mode}/{name}"] = (shd.gather_rows(y), aux)
            if mode == "ep":
                # the rank's own dispatch, as moe_ep_shardmap makes it
                ep = shd.axis_size("model")
                Sl = x.shape[1] // ep
                xl = rows.narrow(1, shd.axis_index("model") * Sl, Sl)
                _, probs, ids = moe_lib.router_probs(local, cfg, xl)
                C = moe_lib._capacity(xl.shape[0] * Sl, cfg, case["cf"])
                _, slot, keep, _ = moe_lib._dispatch_local(
                    cfg, xl.reshape(-1, cfg.d_model), probs, ids, C)
                out["keep"], out["slot"] = keep, slot
    return out


def run_moe_auto(case, cfg, mesh, rules, inp):
    """``moe_apply``'s own choice (path "auto") on the whole batch under
    the rules, and how many times it took ``moe_ep_shardmap``."""
    calls = []
    ep = moe_lib.moe_ep_shardmap
    moe_lib.moe_ep_shardmap = lambda *a, **k: calls.append(1) or ep(*a, **k)
    try:
        local = shd.shard_params(inp["params"], mesh, rules)
        with shd.sharding_ctx(mesh, rules):
            y, aux = moe_lib.moe_apply(local, cfg, shd.batch_rows(inp["x"]))
            y = shd.gather_rows(y)
    finally:
        moe_lib.moe_ep_shardmap = ep
    return {"auto": (y, aux), "ep_calls": len(calls)}


def run_model(case, cfg, mesh, rules, inp):
    """``prefill`` and ``forward`` of the whole batch; then (decode cases)
    ``decode_step`` over the case's steps with the state cut by
    ``shard_decode_state``: the tokens of ``steps``, or (a "greedy" count)
    its first column and then each step's argmax. encdec runs
    ``encoder_forward`` over the whole ``frames`` first, vlm takes the
    whole ``patches``; the state is built whole (whole params, whole
    frontend states) under the mesh, then cut."""
    local = shd.shard_params(inp["params"], mesh, rules)
    # every leaf gathered back over the ranks along its split dims
    specs = shd.param_pspecs(inp["params"], rules, mesh)
    back = shd.gather_tree(local, specs, mesh)
    whole = list(_leaves(inp["params"], specs))
    out = {"roundtrip": [
        (path, torch.equal(b, w) and b.dtype == w.dtype)
        for (path, w, _), (_, b, _) in zip(whole, _leaves(back, specs))],
        "split_leaves": sum(any(a is not None for a in sp)
                            for _, _, sp in whole),
        "model_axis": rules.get("model")}
    out["ssd_calls"], out["flash_calls"], out["flash_strided"] = [], [], []
    with shd.sharding_ctx(mesh, rules), _recording_ssd(out["ssd_calls"]), \
            _recording_flash(out["flash_calls"], out["flash_strided"]):
        enc = inp.get("patches")
        if "frames" in inp:
            enc = out["encoder"] = tf.encoder_forward(local, cfg,
                                                      inp["frames"])
        if "tokens" in inp:
            out["prefill"] = tf.prefill(local, cfg, inp["tokens"], enc=enc)
            out["forward"] = tf.forward(local, cfg, inp["tokens"],
                                        enc=enc)[0]
        if "steps" in inp:
            whole = tf.init_decode_state(inp["params"], cfg,
                                         inp["steps"].shape[0],
                                         case["cache_len"], enc=enc,
                                         device="cpu")
            state = shard_decode_state(whole, mesh, rules)
            out["state_shapes"] = [tuple(v.shape)
                                   for entry in _first_entries(state)
                                   for v in entry.values()]
            logits, tok = [], inp["steps"][:, :1]
            for pos in range(case.get("greedy") or inp["steps"].shape[1]):
                lg, state = tf.decode_step(local, cfg, state, tok, pos,
                                           window=case.get("window"))
                logits.append(lg)
                tok = (lg.argmax(dim=-1, keepdim=True) if case.get("greedy")
                       else inp["steps"][:, pos + 1:pos + 2])
            out["decode"] = torch.stack(logits)
    return out


@contextmanager
def _recording_ssd(calls):
    """Each ``ops.ssd_chunk`` call's dA shape [G, Q, H] into ``calls``."""
    ssd = ssm_lib.kops.ssd_chunk
    ssm_lib.kops.ssd_chunk = lambda dA, *a: calls.append(
        tuple(dA.shape)) or ssd(dA, *a)
    try:
        yield
    finally:
        ssm_lib.kops.ssd_chunk = ssd


@contextmanager
def _recording_flash(calls, strided):
    """Each ``ops.flash_attention`` call's (q shape, k shape, causal) into
    ``calls``, and the same of each call given a q, k or v that is not
    contiguous (which the CUDA kernel refuses) into ``strided``."""
    flash = attn_lib.kops.flash_attention

    def call(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw.get("causal")))
        if not all(t.is_contiguous() for t in (q, k, v)):
            strided.append(calls[-1])
        return flash(q, k, v, **kw)

    attn_lib.kops.flash_attention = call
    try:
        yield
    finally:
        attn_lib.kops.flash_attention = flash


def _first_entries(state):
    """The first layer's entry of each group of a decode state (a hybrid's
    attention group, then its first SSM position's; a vlm's first
    period's first layer)."""
    for group in ("layers", "attn_layers", "ssm_layers"):
        if group in state:
            entry = state[group][0]
            yield entry[0] if isinstance(entry, (list, tuple)) else entry


def run_cost(case, cfg, mesh, rules, inp):
    """The rank's ``OpCost`` report of ``prefill`` of the whole batch or
    (with a "cache_len") of one ``decode_step`` at the cache's last slot,
    the state cut by ``shard_decode_state``; on whatever device the
    inputs are (``meta`` under a fake group)."""
    local = shd.shard_params(inp["params"], mesh, rules)
    tokens = inp["tokens"]
    with shd.sharding_ctx(mesh, rules), torch.no_grad():
        if "cache_len" not in case:
            with OpCost() as cost:
                tf.prefill(local, cfg, tokens)
        else:
            L = case["cache_len"]
            whole = tf.init_decode_state(local, cfg, tokens.shape[0], L,
                                         device=tokens.device)
            state = shard_decode_state(whole, mesh, rules)
            with OpCost() as cost:
                tf.decode_step(local, cfg, state, tokens, L - 1)
    return cost.to_dict()


def run_train(case, cfg, mesh, rules, inp):
    """``train_loop.loss_and_grads`` of the whole ``batch`` under the
    rules, then one ``make_train_step`` step (AdamW at the case's lr),
    each from ``shard_params``' slices of a copy of the whole params, the
    moments from ``init_opt_state`` (cut on the data axis too for a
    ZeRO-1 config): the loss of each, the gradients' ``global_norm``, the
    gradients, the stepped params and moments gathered whole
    (``gather_tree``; the gradients and moments by the moments' specs).
    A case's "aux_weight" stands in for ``transformer.AUX_WEIGHT``. Each
    flash call given a strided q, k or v goes into ``flash_strided``."""
    whole, batch = inp["params"], inp["batch"]
    path = case.get("moe_path", "auto")
    aux_weight = tf.AUX_WEIGHT
    tf.AUX_WEIGHT = case.get("aux_weight", aux_weight)
    out = {"flash_calls": [], "flash_strided": []}
    try:
        with shd.sharding_ctx(mesh, rules), \
                _recording_flash(out["flash_calls"], out["flash_strided"]):
            specs = train_loop.param_specs(cfg)
            moments = train_loop.opt_specs(cfg)["m"]
            out["specs_match"] = specs == shd.param_pspecs(whole, rules,
                                                           mesh)
            out["zero1_leaves"] = sum(
                shd.added_axis(sp, m) is not None for (_, _, sp), (_, _, m)
                in zip(_leaves(whole, specs), _leaves(whole, moments)))
            local = shd.shard_params(_copy(whole), mesh, rules)
            loss, grads = train_loop.loss_and_grads(local, cfg, batch,
                                                    moe_path=path)
            out.update(loss=loss, norm=global_norm(grads, moments),
                       grads=shd.gather_tree(grads, moments, mesh))
            local = shd.shard_params(_copy(whole), mesh, rules)
            step = make_train_step(cfg, opt_cfg=AdamWConfig(lr=case["lr"]),
                                   moe_path=path)
            params, state, out["step_loss"] = step(
                local, init_opt_state(local, cfg), batch)
            out["params"] = shd.gather_tree(params, specs, mesh)
            out["moments"] = {k: shd.gather_tree(state[k], moments, mesh)
                              for k in ("m", "v")}
    finally:
        tf.AUX_WEIGHT = aux_weight
    return out


def _copy(tree):
    return tf._tree_map(torch.clone, tree)


def _leaves(tree, specs, path=""):
    """(path, leaf, its spec) in order; ``tree`` decides what a leaf is."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], specs[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, (t, sp) in enumerate(zip(tree, specs)):
            yield from _leaves(t, sp, f"{path}/{i}")
    else:
        yield path, tree, specs


RUNS = {"moe": run_moe, "moe_auto": run_moe_auto, "model": run_model,
        "cost": run_cost, "train": run_train}


def run_case(case, mesh, inp):
    """One case under its rules (the JAX test's, or ``sharding_rules``'
    when it gives none); a case of kind "parts" runs each of its parts,
    a case of its own, on the same ranks, outputs under the part's
    name."""
    if case["kind"] == "parts":
        return {name: run_case(part, mesh, inp[name])
                for name, part in case["parts"].items()}
    cfg = case_config(case)
    rules = case["rules"] or sharding_rules(cfg, mesh)
    return RUNS[case["kind"]](case, cfg, mesh, rules, inp)


def main(case_file, rank, world):
    torch.set_num_threads(1)
    case_file = Path(case_file)
    case = json.loads(case_file.read_text())
    dist.init_process_group("gloo", init_method=case["store"], rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(tuple(case["mesh"]),
                         tuple(case.get("axes", ("data", "model"))), "cpu")
        inp = torch.load(case["inputs"], weights_only=True)
        torch.save(run_case(case, mesh, inp),
                   case_file.parent / f"out-{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

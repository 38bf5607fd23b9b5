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
that the ranks agree. A part of a "parts" case may name a mesh of its
own ("mesh", "axes"): every rank builds it, in the parts' order.
"""
import dataclasses
import json
import sys
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.offload_engine import (OffloadEngine,  # noqa: E402
                                             _batch_union)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh, sharding_rules  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402
from repro_torch.launch.specs import shard_decode_state  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.serving.offload_serving import (  # noqa: E402
    ContinuousOffloadServer)
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


BLOCK = 4   # tokens a KV block, in the per-row and paged decode checks
FUNCTIONAL = ("activated", "hits", "misses", "evicted", "spec_guess",
              "prefetched")


def per_row_decodes(p, cfg, x, pos, tables, *, paged):
    """One layer's per-row (``paged=False``: ``*_decode_multipos`` over a
    dense cache of ``tables.shape[1] * BLOCK`` slots) or paged decode
    (``*_decode_paged`` over a pool of ``tables.max() + 1`` blocks),
    called once for each of ``x``'s steps [n, B, 1, d], row b at position
    ``pos[b] + i``; the cache made here under the active mesh (a dense one
    built whole and cut by ``shard_decode_state``, a pool the rank's).
    Returns every call's output [n, B, 1, d]."""
    B = x.shape[1]
    mla = cfg.use_mla
    if paged:
        init = (attn_lib.mla_paged_cache_init if mla
                else attn_lib.gqa_paged_cache_init)
        cache = init(cfg, int(tables.max()) + 1, BLOCK, torch.float32, "cpu")
        decode = (attn_lib.mla_decode_paged if mla
                  else attn_lib.gqa_decode_paged)
    else:
        init = attn_lib.mla_cache_init if mla else attn_lib.gqa_cache_init
        cache = init(cfg, B, tables.shape[1] * BLOCK, torch.float32, "cpu")
        if shd.active_mesh() is not None:
            cache = shard_decode_state(cache, shd.active_mesh(),
                                       shd.active_rules())
        decode = (attn_lib.mla_decode_multipos if mla
                  else attn_lib.gqa_decode_multipos)
    out = []
    for i in range(x.shape[0]):
        pv = torch.as_tensor(np.asarray(pos) + i, dtype=torch.int32)
        y, cache = decode(p, cfg, x[i], cache, pv,
                          *((tables,) if paged else ()))
        out.append(y)
    return torch.stack(out)


def paged_greedy(params, cfg, first, n, tables):
    """``n`` greedy steps from the tokens ``first`` [B, 1] with every
    layer's attention through ``_attn_decode_paged`` over its own pool
    (made here, under the active mesh) and the rows' blocks ``tables``:
    (tokens [B, n], logits [n, B, V])."""
    init = (attn_lib.mla_paged_cache_init if cfg.use_mla
            else attn_lib.gqa_paged_cache_init)
    pools = [init(cfg, int(tables.max()) + 1, BLOCK, torch.float32, "cpu")
             for _ in range(cfg.num_layers)]
    tok, toks, logits = first, [], []
    for pos in range(n):
        pv = torch.full((first.shape[0],), pos, dtype=torch.int32)
        h = tf._embed(params, cfg, tok, pv[:, None].long())
        for l in range(cfg.num_layers):
            p = tf._layer(params["layers"], l)
            h, pools[l] = tf._attn_decode_paged(p, cfg, h, pools[l], pv,
                                                tables)
            h, _ = tf._ffn_full(p, cfg, h, "auto")
        lg = tf.logits_from_hidden(params, cfg, h)[:, 0]
        tok = lg.argmax(dim=-1, keepdim=True)
        toks.append(tok)
        logits.append(lg)
    return torch.cat(toks, 1), torch.stack(logits)


def run_decodes(case, cfg, mesh, rules, inp):
    """The four decodes under the mesh: layer 0's per-row and paged
    decode (``per_row_decodes``, its attention params cut by
    ``shard_params``), the KV heads of the rank's pool, a pool made
    without a mesh refused where its head count differs; then greedy
    decodes of the whole model: ``decode_step`` (the per-row core; the
    state built whole and cut) and ``paged_greedy``."""
    whole = inp["params"]
    local = shd.shard_params(whole, mesh, rules)
    x, pos, tables = inp["x"], inp["pos"], inp["tables"]
    first, n = inp["first"], case["greedy"]
    out = {}
    plain_pool = None
    if not cfg.use_mla:
        plain_pool = attn_lib.gqa_paged_cache_init(cfg, 4, BLOCK,
                                                   torch.float32, "cpu")
    with shd.sharding_ctx(mesh, rules):
        p = tf._layer(local["layers"], 0)["attn"]
        out["multipos"] = per_row_decodes(p, cfg, x, pos, tables,
                                          paged=False)
        out["paged"] = per_row_decodes(p, cfg, x, pos, tables, paged=True)
        init = (attn_lib.mla_paged_cache_init if cfg.use_mla
                else attn_lib.gqa_paged_cache_init)
        out["pool_shape"] = tuple(next(iter(init(
            cfg, 1, BLOCK, torch.float32, "cpu").values())).shape)
        if plain_pool is not None and \
                plain_pool["k"].shape[2] != out["pool_shape"][2]:
            try:
                attn_lib.gqa_decode_paged(p, cfg, x[0], plain_pool,
                                          torch.zeros(x.shape[1],
                                                      dtype=torch.int32),
                                          tables.clamp(max=3))
                out["plain_pool"] = "ran"
            except ValueError as e:
                out["plain_pool"] = str(e)
        state = shard_decode_state(
            tf.init_decode_state(whole, cfg, first.shape[0], n,
                                 device="cpu"), mesh, rules)
        out["state_shapes"] = [tuple(v.shape)
                               for v in state["layers"][0].values()]
        tok, toks, logits = first, [], []
        for i in range(n):
            lg, state = tf.decode_step(local, cfg, state, tok, i)
            tok = lg.argmax(dim=-1, keepdim=True)
            toks.append(tok)
            logits.append(lg)
        out["greedy"] = (torch.cat(toks, 1), torch.stack(logits))
        out["paged_greedy"] = paged_greedy(local, cfg, first, n,
                                           inp["greedy_tables"])
    return out


def track_margins(engine, seen, splits=None):
    """Record, per MoE call of ``engine``, the smallest gap between two
    summed gate weights of the active rows' batch union (the order the
    engine streams and traces) and between the k-th and (k+1)-th router
    logit of an active row (where k < E); and into ``splits`` whether the
    call's rows were split over the batch axes."""
    orig = engine._moe_offloaded
    cfg = engine.cfg

    def wrapped(p_l, layer, h, *rest):
        active = rest[-1]
        if splits is not None:
            splits.append(shd.batch_axis() is not None)
        x = rms_norm(h, p_l["ln2"], cfg.norm_eps)
        ids, probs = engine._route(p_l, x)
        union, w = _batch_union(ids, probs, active, cfg.num_experts)
        gaps = -np.diff(w[union])
        k = cfg.num_experts_per_tok
        if k < cfg.num_experts:
            logits = shd.gather_rows(x.float() @ p_l["moe"]["router"])
            logits = logits[:, 0].numpy()
            srt = -np.sort(-logits, axis=-1)[np.asarray(active, bool)]
            gaps = np.concatenate([gaps, srt[:, k - 1] - srt[:, k]])
        if gaps.size:
            seen.append(float(gaps.min()))
        return orig(p_l, layer, h, *rest)

    engine._moe_offloaded = wrapped


def _plain(x):
    """``x`` with every numpy scalar made a Python one (``torch.load``'s
    weights-only reader takes no numpy)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x.item() if isinstance(x, np.generic) else x


def run_engine(case, cfg, mesh, rules, inp):
    """``OffloadEngine.generate`` of the case's prompt (the dense per-row
    path), or a ``ContinuousOffloadServer`` over the case's prompts, built
    and run inside the mesh from the whole params: tokens, functional
    trace rows, ``stats()``, the simulated clock, the last logits, the
    smallest router margin, whether each MoE call's rows were split over
    the batch axes, the rank's KV pool shape and the calls of each kernel
    wrapper. A case with "refuse" builds the engine inside the mesh and
    steps it (``generate``) under the case's "step_mesh" and under no
    mesh: the errors each raised."""
    whole = inp["params"]
    margins, splits, out = [], [], {}
    if "refuse" in case:
        with shd.sharding_ctx(mesh, rules):
            eng = OffloadEngine(whole, cfg, device="cpu", **case["refuse"])
        errors = []
        for other in (part_mesh({"mesh": case["step_mesh"]}, mesh), None):
            try:
                with shd.sharding_ctx(other, rules if other else {}):
                    eng.generate([1, 2, 3], 2)
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        return {"errors": errors}
    with shd.sharding_ctx(mesh, rules):
        counts = {"paged_attention": 0, "moe_ffn": 0}
        wrapped = {name: getattr(ops, name) for name in counts}

        def counting(name):
            def call(*a, **kw):
                counts[name] += 1
                return wrapped[name](*a, **kw)
            return call

        for name in counts:
            setattr(ops, name, counting(name))
        try:
            if "prompt" in case:
                eng = OffloadEngine(whole, cfg, device="cpu",
                                    **case["engine"])
                track_margins(eng, margins, splits)
                out["tokens"] = eng.generate(case["prompt"], case["new"])
            else:
                srv = ContinuousOffloadServer(whole, cfg, device="cpu",
                                              **case["server"])
                eng = srv.engine
                track_margins(eng, margins, splits)
                for prompt in case["prompts"]:
                    srv.submit(prompt, max_new=case["new"])
                out["tokens"] = srv.run()
                out["server_stats"] = _plain(srv.stats())
                out["logits"] = srv._logits
                if srv.paged is not None:
                    out["pool_shape"] = tuple(next(iter(
                        srv.paged.state["layers"][0].values())).shape)
        finally:
            for name, fn in wrapped.items():
                setattr(ops, name, fn)
    out.update(
        rows=_plain([tuple(getattr(s, f) for f in FUNCTIONAL)
                     for s in eng.trace.steps]),
        stats=_plain(eng.stats()), sim_time=eng.sim_time,
        margin=min(margins), splits=splits, launches=counts,
        attn_shape=tuple(eng.params["layers"]["attn"]["wq"].shape),
        expert_shape=tuple(eng.params["layers"]["moe"]["experts"]["w1"]
                           .shape))
    return out


def run_tiers(case, cfg, mesh, rules, inp):
    """A tiered ``ContinuousOffloadServer`` (the case's "server" kwargs
    with ``hbm_budget_bytes``; "faults" a ``FaultPlan``'s) built and run
    inside the mesh from the whole params over the case's prompts:
    tokens, the trace rows with ``miss_tiers``, the tier and fault
    events, ``stats()``, the clock, each park's priced bytes and the
    rank's own snapshot, the KV heads of the rank's pool (unsharded
    indices), the smallest router margin and whether each MoE call's rows
    were split over the batch axes."""
    margins, splits, parks = [], [], []
    faults = case.get("faults")
    with shd.sharding_ctx(mesh, rules):
        srv = ContinuousOffloadServer(
            inp["params"], cfg, device="cpu",
            faults=faults and FaultPlan(**faults), **case["server"])
        track_margins(srv.engine, margins, splits)
        park = srv.tiers.park_kv

        def parked(rid, arrays, nbytes, *args, **kw):
            parks.append((nbytes, [{k: v.clone() for k, v in layer.items()}
                                   for layer in arrays]))
            return park(rid, arrays, nbytes, *args, **kw)

        srv.tiers.park_kv = parked
        for prompt in case["prompts"]:
            srv.submit(prompt, max_new=case["new"])
        tokens = srv.run()
        kv_heads = attn_lib._gqa_heads(cfg.num_heads, cfg.num_kv_heads)[3]
    trace = srv.trace
    return _plain({
        "tokens": tokens, "rows": [
            tuple(getattr(s, f) for f in FUNCTIONAL + ("miss_tiers",))
            for s in trace.steps],
        "tier_events": [dataclasses.astuple(e) for e in trace.tier_events],
        "fault_events": [dataclasses.astuple(e)
                         for e in trace.fault_events],
        "stats": srv.stats(), "sim_time": srv.engine.sim_time,
        "park_bytes": [n for n, _ in parks],
        "snapshots": [layers for _, layers in parks],
        "kv_heads": list(kv_heads), "margin": min(margins),
        "splits": splits, "logits": srv._logits})


RUNS = {"moe": run_moe, "moe_auto": run_moe_auto, "model": run_model,
        "cost": run_cost, "train": run_train, "decodes": run_decodes,
        "engine": run_engine, "tiers": run_tiers}
_MESHES = {}


def part_mesh(case, mesh):
    """The case's own mesh where it names one (built once, by every rank
    in the parts' order), else ``mesh``."""
    if "mesh" not in case:
        return mesh
    key = (tuple(case["mesh"]), tuple(case.get("axes", ("data", "model"))))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(*key, "cpu")
    return _MESHES[key]


def run_case(case, mesh, inp):
    """One case under its rules (the JAX test's, or ``sharding_rules``'
    when it gives none); a case of kind "parts" runs each of its parts,
    a case of its own, on the same ranks (on its own mesh where it names
    one), outputs under the part's name."""
    if case["kind"] == "parts":
        return {name: run_case(part, part_mesh(part, mesh), inp[name])
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

"""What each gloo CPU rank of the mesh tests runs (see ``_torch_ranks``):
the port's sharded train step, its expert-parallel MoE layer, and a save
and an elastic resume.  No JAX here: weights and batches arrive as numpy.
Rank 0 hands back whole (``full_tensor``) results; the others ``None``."""

from __future__ import annotations

import collections
import contextlib
from dataclasses import replace

import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.dryrun import make_context
from repro_torch.launch.mesh import make_debug_mesh, make_mesh
from repro_torch.models.model import build_model, cross_entropy_loss
from repro_torch.parallel.context import ParallelContext, default_rules, parallel_context
from repro_torch.parallel.moe_parallel import moe_ep
from repro_torch.parallel.sharding import distribute, param_pspec_tree, param_shardings, pure_dp_active
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.elastic import elastic_resume
from repro_torch.train.optimizer import AdamWConfig, adamw_update, decay_mask, init_opt_state
from repro_torch.train.step import (make_train_pieces, make_train_step, stacked_groups,
                                    value_and_grad)
from repro_torch.train.tree import leaves, tree_map

CPU = torch.device("cpu")
OPT = dict(lr=1e-3, warmup_steps=1)


def _np(tree):
    return tree_map(lambda x: x.detach().float().numpy() if x.dtype == torch.bfloat16
                    else x.detach().numpy(), tree)


def _whole(tree):
    return _np(tree_map(lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x, tree))


def _setup(arch, cfg_kw, init_np, global_batch, n_ranks):
    cfg = replace(get_config(arch).smoke(), **cfg_kw)
    mesh = make_debug_mesh(n_ranks, device_type="cpu")
    ctx = make_context(mesh, cfg, global_batch)
    params = param_shardings(cfg, mesh, params_from_jax(init_np, CPU),
                             pure_dp=pure_dp_active(cfg, mesh, global_batch))
    return cfg, mesh, ctx, params


def train_steps(rank, world, cases):
    """One sharded step on the debug mesh for each ``(arch, cfg_kw, init,
    batch)`` of ``cases`` (``init``: numpy params, the reference's or the
    port's, the same on every rank): layout, loss, grad norm, whole new
    params and moments."""
    out = []
    for arch, cfg_kw, init_np, batch in cases:
        b = batch["labels"].shape[0]
        cfg, mesh, ctx, params = _setup(arch, cfg_kw, init_np, b, world)
        step = make_train_step(build_model(cfg), AdamWConfig(**OPT))
        with parallel_context(ctx):
            p2, o2, m = step(params, init_opt_state(params, mesh=mesh), batch)
        out.append({"layout": (ctx.dp_axes, ctx.tp_axis), "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]), "params": _whole(p2),
                    "m": _whole(o2["m"]), "v": _whole(o2["v"])})
    return out if rank == 0 else None


def quant8_steps(rank, world, arch, cfg_kw, init_np, batches):
    """Sharded steps on the debug mesh with 8-bit moments, one a batch of
    ``batches``: each step's loss and grad norm, the whole params after
    the first step, and the whole 8-bit moments (``q`` and the row scales
    ``s``) after the last."""
    b = batches[0]["labels"].shape[0]
    cfg, mesh, ctx, params = _setup(arch, cfg_kw, init_np, b, world)
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT))
    opt = init_opt_state(params, quant8=True, mesh=mesh)
    out = {"losses": [], "grad_norms": []}
    with parallel_context(ctx):
        for batch in batches:
            params, opt, m = step(params, opt, batch)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            out.setdefault("params", _whole(params))
    out.update(m=_whole(opt["m"]), v=_whole(opt["v"]))
    return out if rank == 0 else None


def serve_steps(rank, world, cases):
    """For each ``(arch, cfg_kw, init, batch, mesh_shape, steps, stepwise)``
    of ``cases``: the prompt prefilled on a mesh of ``mesh_shape`` (its
    ``make_context``, the cache in ``cache_pspec_tree``'s layout, room for
    ``steps`` more tokens) — or, ``stepwise``, fed one token a decode step
    into a cache from ``init_cache`` —, then ``steps`` decode steps, each
    fed the greedy token of the one before (``vocab.greedy_tokens``).  Rank
    0 hands back the whole logits of the prompt's last position and of
    each step, the tokens, and the whole cache at the end."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.parallel.sharding import batch_pspecs
    from repro_torch.parallel.vocab import greedy_tokens

    out = []
    for arch, cfg_kw, init_np, batch, mesh_shape, steps, stepwise in cases:
        cfg = replace(get_config(arch).smoke(), **cfg_kw)
        b, s = batch["tokens"].shape
        mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
        ctx = make_context(mesh, cfg, b)
        params = param_shardings(cfg, mesh, params_from_jax(init_np, CPU),
                                 pure_dp=pure_dp_active(cfg, mesh, b))
        specs = batch_pspecs(cfg, ShapeConfig("serve", seq_len=s, global_batch=b,
                                              kind="prefill"), mesh)
        model = build_model(cfg)
        rec = {"layout": str(mesh), "logits": [], "tokens": []}
        with torch.no_grad(), parallel_context(ctx):
            prompt = {k: distribute(torch.as_tensor(v), mesh, specs[k]) for k, v in batch.items()}
            if stepwise:
                caches = model.init_cache(b, s + steps)
                for t in range(s):
                    one = {"tokens": distribute(torch.as_tensor(batch["tokens"][:, t:t + 1]),
                                                mesh, specs["tokens"])}
                    logits, caches = model.decode_step(params, one, caches,
                                                       torch.tensor(t, dtype=torch.int32))
            else:
                logits, caches = model.prefill(params, prompt, s + steps)
            for t in range(steps):
                rec["logits"].append(logits.full_tensor().numpy())
                tok = greedy_tokens(logits).full_tensor()
                rec["tokens"].append(tok.numpy())
                nxt = {"tokens": distribute(tok.reshape(b, 1), mesh, specs["tokens"])}
                logits, caches = model.decode_step(params, nxt, caches,
                                                   torch.tensor(s + t, dtype=torch.int32))
            rec["logits"].append(logits.full_tensor().numpy())
            rec["cache"] = _whole(caches)
            rec["cache_layout"] = {str(k): str(getattr(v, "placements", None)) for k, v in
                                   _first_leaves(caches).items()}
        out.append(rec)
    return out if rank == 0 else None


@contextlib.contextmanager
def wrapper_calls():
    """Count the calls of the kernels' wrappers (flash attention, RMSNorm,
    the SSD scan) the models make; each call goes through to the wrapper,
    which takes its plain route on a CPU tensor."""
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan

    calls = collections.Counter()
    saved = []
    for mod, name in ((flash_attention, "flash_attention"), (rmsnorm, "rmsnorm"),
                      (ssd_scan, "ssd_scan")):
        inner = getattr(mod, name)

        def counted(*args, _inner=inner, _name=name, **kwargs):
            calls[_name] += 1
            return _inner(*args, **kwargs)

        saved.append((mod, name, inner))
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)


def kernel_serve_steps(rank, world, cases):
    """:func:`serve_steps` of each case on its own, with the wrappers'
    calls counted: (the record, the calls) for each case on rank 0."""
    out = []
    for case in cases:
        with wrapper_calls() as calls:
            (rec,) = serve_steps(rank, world, [case]) or [None]
        out.append((rec, dict(calls)))
    return out if rank == 0 else None


def _first_leaves(caches) -> dict:
    """The cache's first tensor under each top key (its placements show the
    layout)."""
    return {k: leaves(v)[0] for k, v in caches.items()}


def moe_layers(rank, world, cases):
    """``moe_ep`` on a (2 × 2) mesh for each ``(arch, cfg_kw, pure, p, x)``
    of ``cases``: (whole y, aux, this rank's dropped slots)."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = []
    for arch, cfg_kw, pure, p_np, x_np in cases:
        cfg = replace(get_config(arch).smoke(), **cfg_kw)
        ctx = ParallelContext(mesh, default_rules(False), ep_axes=("data",),
                              dp_axes=("data", "model") if pure else ("data",),
                              tp_axis=None if pure else "model")
        p = params_from_jax(p_np, CPU)
        specs = param_pspec_tree(cfg, mesh, {"moe": p}, pure_dp=pure)["moe"]
        pd = {k: distribute(v, mesh, specs[k]) for k, v in p.items()}
        xd = distribute(torch.from_numpy(x_np), mesh, (ctx.dp_axes, None, None))
        stats = {}
        with torch.no_grad():
            y, aux = moe_ep(pd, xd, cfg, ctx, stats=stats)
        out.append({"y": y.full_tensor().numpy(), "aux": float(aux.full_tensor()),
                    "drops": stats["dropped"]})
    return out


def save_then_step(rank, world, arch, cfg_kw, init_np, batches, ckpt, at):
    """A step on ``batches[0]``, a checkpoint as step ``at``, then a step
    on ``batches[1]``: its loss."""
    b = batches[0]["labels"].shape[0]
    cfg, mesh, ctx, params = _setup(arch, cfg_kw, init_np, b, world)
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT))
    with parallel_context(ctx):
        p, o, _ = step(params, init_opt_state(params, mesh=mesh), batches[0])
        save_checkpoint(ckpt, at, {"params": p, "opt": o})
        _, _, m = step(p, o, batches[1])
    return {"layout": str(mesh), "loss": float(m["loss"])} if rank == 0 else None


def resume_then_step(rank, world, arch, cfg_kw, ckpt, batch):
    """``elastic_resume`` on this world's debug mesh, then a step: (step,
    the whole restored state, the step's loss)."""
    cfg = replace(get_config(arch).smoke(), **cfg_kw)
    mesh = make_debug_mesh(world, device_type="cpu")
    b = batch["tokens"].shape[0]
    at, params, opt = elastic_resume(cfg, mesh, ckpt, global_batch=b)
    restored = {"params": _whole(params), "opt": _whole(opt)}
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT))
    with parallel_context(make_context(mesh, cfg, b)):
        _, _, m = step(params, opt, batch)
    out = {"layout": str(mesh), "step": at, "restored": restored, "loss": float(m["loss"]),
           "sharded": str(params["layers"][0]["attn"]["wq"].placements)}
    return out if rank == 0 else None


def routed_redistributions(rank, world):
    """DTensor's redistributions with its functional collectives routed
    through the eager calls (as ``init_ranks`` does for gloo ranks on
    cards; here on the CPU): each result, and the log of the calls."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.parallel.collectives import log_collectives, route_functional_collectives

    route_functional_collectives("cpu")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    full = torch.arange(64.0).reshape(8, 8)
    d = distribute(full, mesh, ("data", "model"))
    ones = DTensor.from_local(torch.ones(4, 4), mesh.device_mesh, [Partial(), Shard(0)])
    with log_collectives() as log:
        out = {
            "full": d.full_tensor(),
            "resharded": d.redistribute(mesh.device_mesh, [Shard(1), Shard(0)]).full_tensor(),
            "summed": ones.redistribute(mesh.device_mesh, [Replicate(), Replicate()]).to_local(),
            "scattered": ones.redistribute(mesh.device_mesh, [Shard(1), Shard(0)]).to_local(),
        }
    out["log"] = {k: list(v) for k, v in log.items()}
    return out


DISTRIBUTE_CASES = [((8, 6), ("data", "model")), ((5, 6), ("data", "model")),
                    ((3, 8), (("data", "model"), None)), ((4, 7), (None, "model")), ((6,), (None,))]


def distribute_cases(rank, world):
    """For each ``(shape, spec)`` of ``DISTRIBUTE_CASES`` (even and uneven
    splits, an empty shard, two mesh axes on one dim): whether
    ``distribute``'s local shard, placements and global shape are
    ``distribute_tensor``'s, and a shard smaller than the tensor a copy."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import placements

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = []
    for shape, spec in DISTRIBUTE_CASES:
        x = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
        got = distribute(x, mesh, spec)
        want = distribute_tensor(x, mesh.device_mesh, placements(spec, mesh), src_data_rank=None)
        mine = got.to_local()
        out.append(torch.equal(mine, want.to_local()) and got.placements == want.placements
                   and got.shape == want.shape
                   and (mine.numel() == x.numel() or mine.data_ptr() != x.data_ptr()))
    return out


def checkpoint_on_ranks(rank, world, directory):
    """A tree of DTensors saved by ``AsyncCheckpointer`` (step 5) and by
    ``save_checkpoint`` (step 6): after ``wait`` / the call, whether this
    rank sees each step committed, whether it started a write, and (rank
    0) the tree restored to the host, against the whole tree."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(5)
    whole = {"w": torch.randn(8, 6, generator=g).to(torch.bfloat16),
             "m": [torch.randn(5, 4, generator=g), torch.randn(3, generator=g)]}
    specs = {"w": ("data", "model"), "m": [(None, "model"), (("data", "model"),)]}
    tree = tree_map(lambda x, s: distribute(x, mesh, s), whole, specs)
    ck = AsyncCheckpointer(directory)
    ck.save(5, tree)
    ck.wait()
    out = {"async_committed": latest_step(directory) == 5, "wrote": ck.write_s is not None}
    save_checkpoint(directory, 6, tree)
    out["sync_committed"] = latest_step(directory) == 6
    if rank == 0:
        for at in (5, 6):
            _, back = restore_checkpoint(directory, whole, step=at, device=CPU)
            out[at] = all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(whole)))
    return out


def batch_rows(batch, n):
    """The batch cut into ``n`` row blocks, in rank order."""
    b = batch["labels"].shape[0]
    return [{k: v[i * b // n:(i + 1) * b // n] for k, v in batch.items()} for i in range(n)]


def single_step(model, params, batch, opt_cfg, *, aux_shards=1, opt=None):
    """The port's single-process step on ``params`` from ``opt`` (a fresh
    state if ``None``; a numpy batch goes to their device).  ``aux_shards
    > 1``: the sharded MoE step's objective — the whole batch's
    cross-entropy plus the mean over ``aux_shards`` row blocks of each
    block's load-balancing loss (each DP rank's router statistics,
    averaged as the reference's ``pmean`` does)."""
    opt = init_opt_state(params) if opt is None else opt
    if aux_shards == 1:
        return make_train_step(model, opt_cfg)(params, opt, batch)
    dev = leaves(params)[0].device
    tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def loss_fn(p, bt):
        logits, _ = model.train_forward(p, bt)
        aux = sum(model.train_forward(p, rows)[1] for rows in batch_rows(bt, aux_shards))
        return cross_entropy_loss(logits, bt["labels"], aux_loss=aux / aux_shards)

    loss, grads = value_and_grad(loss_fn, params, tb)
    p2, o2, gnorm = adamw_update(opt_cfg, params, grads, opt,
                                 decay=decay_mask(params, stacked_groups(model.cfg)))
    return p2, o2, {"loss": loss, "grad_norm": gnorm}



@contextlib.contextmanager
def weight_gathers(weights):
    """Record each redistribution that gathers one of ``weights`` (``{name:
    DTensor}``): one whose source is cut on a mesh dim where its target is
    not.  DTensor runs every redistribution — an explicit one, and those
    its operators make to meet their sharding rules — through
    ``redistribute_local_tensor``; a call on a weight's own local storage
    is a redistribution of that weight.  Yields the list of names."""
    from torch.distributed.tensor import _api, _dispatch, _redistribute

    watched = {w.to_local().untyped_storage()._cdata: name for name, w in weights.items()}
    seen = []
    inner = _redistribute.redistribute_local_tensor

    def spy(local, current, target, *args, **kwargs):
        name = watched.get(local.untyped_storage()._cdata)
        if name is not None and any(c.is_shard() and not t.is_shard()
                                    for c, t in zip(current.placements, target.placements)):
            seen.append(name)
        return inner(local, current, target, *args, **kwargs)

    mods = (_api, _dispatch, _redistribute)
    for mod in mods:
        mod.redistribute_local_tensor = spy
    try:
        yield seen
    finally:
        for mod in mods:
            mod.redistribute_local_tensor = inner


def mamba_weight_gathers(rank, world, arch, cfg_kw, init_np, batch, steps):
    """Prefill, ``steps`` greedy decode steps and one train step of
    ``arch`` on the (2 × 2) debug mesh, each watched by
    :func:`weight_gathers` over every Mamba weight: the names each gathered
    (none, where the trunk runs on each rank's own shards), and, as a check
    that the watch sees a gather, those that ``full_tensor`` of the first
    layer's ``w_x`` records.  The train step is watched in two pieces: the
    model's forward and backward (``train``) and the update (``update``,
    where ZeRO-1 moves each weight into its moments' layout)."""
    from repro_torch.parallel.vocab import greedy_tokens
    from repro_torch.train.tree import leaves_with_paths

    b, s = batch["tokens"].shape
    cfg, mesh, ctx, params = _setup(arch, cfg_kw, init_np, b, world)
    key = "mamba_layers" if cfg.family == "hybrid" else "layers"
    mamba = {"/".join(map(str, path)): w for path, w in leaves_with_paths(params[key])
             if "mamba" in path}
    model = build_model(cfg)
    prompt = {"tokens": distribute(torch.as_tensor(batch["tokens"]), mesh, ("data", None))}
    out = {"watched": len(mamba)}
    with parallel_context(ctx):
        with torch.no_grad(), weight_gathers(mamba) as seen:
            logits, caches = model.prefill(params, prompt, s + steps)
        out["prefill"] = list(seen)
        with torch.no_grad(), weight_gathers(mamba) as seen:
            for t in range(steps):
                tok = greedy_tokens(logits).full_tensor().reshape(b, 1)
                nxt = {"tokens": distribute(tok, mesh, ("data", None))}
                logits, caches = model.decode_step(params, nxt, caches,
                                                   torch.tensor(s + t, dtype=torch.int32))
        out["decode"] = list(seen)
        start, micro, finish = make_train_pieces(model, AdamWConfig(**OPT))
        opt = init_opt_state(params, mesh=mesh)
        with weight_gathers(mamba) as seen:
            acc = micro(params, start(params, batch), 0)
        out["train"] = list(seen)
        with weight_gathers(mamba) as seen:
            finish(params, opt, acc)
        out["update"] = list(seen)
        first = next(n for n in mamba if n.endswith("w_x"))
        with weight_gathers(mamba) as seen:
            mamba[first].full_tensor()
        out["probe"] = list(seen)
    return out if rank == 0 else None


def kernel_serve_heads(rank, world, cases):
    """:func:`serve_steps` of each case on its own, with the wrappers'
    calls counted and the head count of each SSD-scan call: (the record,
    the calls, ``{H: calls}``) for each case on rank 0."""
    from repro_torch.kernels import ssd_scan

    out = []
    for case in cases:
        heads = collections.Counter()
        inner = ssd_scan.ssd_scan

        def scan(x, *args, **kwargs):
            heads[x.shape[2]] += 1
            return inner(x, *args, **kwargs)

        ssd_scan.ssd_scan = scan
        try:
            with wrapper_calls() as calls:
                (rec,) = serve_steps(rank, world, [case]) or [None]
        finally:
            ssd_scan.ssd_scan = inner
        out.append((rec, dict(calls), dict(heads)))
    return out if rank == 0 else None


def mesh_ssm_runs(rank, world, serve_cases, train_cases, gather_cases, kernel_cases):
    """The rank side of ``test_torch_mesh_ssm.py`` in one group of ranks:
    :func:`serve_steps`, :func:`train_steps`, :func:`mamba_weight_gathers`
    (one each of ``gather_cases``) and :func:`kernel_serve_heads`."""
    out = {"serve": serve_steps(rank, world, serve_cases),
           "train": train_steps(rank, world, train_cases),
           "gathers": [mamba_weight_gathers(rank, world, *c) for c in gather_cases],
           "kernels": kernel_serve_heads(rank, world, kernel_cases)}
    return out if rank == 0 else None

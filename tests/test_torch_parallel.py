"""The port's parallel layer against the JAX reference.

* The rules: ``param_pspec_tree`` (TP and pure DP), ``_zero1_spec`` through
  ``zero1_shardings`` (fp32 and 8-bit moments), ``batch_pspecs``,
  ``cache_pspec_tree``, ``pure_dp_active``, ``dp_axes_for`` and
  ``make_context`` give the reference's specs entry for entry, for all 10
  configs at full size (their trees from the reference's ``jax.eval_shape``)
  on the abstract meshes (16, 16), (2, 16, 16), (2, 4) and (4, 2)
  (``jax.sharding.AbstractMesh`` on the reference's side).
* ``moe_ep`` on four gloo CPU ranks against the reference's ``moe_ep`` on
  four forced CPU devices (a (2 × 2) Auto-axes mesh, in a subprocess), on
  the same weights and tokens: TP inside the experts and pure DP × EP, at
  capacity factor 8.0 (no drops: also the dense oracle ``moe_reference``)
  and 1.0 (drops), and arctic's weight-gathered mode.
* Outside a context the hints change nothing: ``shard_hint`` hands back
  its tensor and ``moe_apply`` runs its sorted dispatch.
"""

import functools
import os
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from _torch_ranks import start_ranks, start_reference
from repro.configs import ARCHS, SHAPES, get_config
from repro.models.model import build_model
from repro.models.moe import moe_params
from repro.parallel import sharding as j_sharding
from repro.train import optimizer as j_opt
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import make_context
from repro_torch.launch.mesh import Mesh, PartitionSpec, make_debug_mesh, make_production_mesh
from repro_torch.models.moe import moe_apply, moe_reference
from repro_torch.parallel import sharding as t_sharding
from repro_torch.parallel.context import ParallelContext, default_rules, parallel_context, shard_hint
from repro_torch.train import optimizer as t_opt
from repro_torch.train.tree import leaves_with_paths

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
BATCHES = (1, 2, 4, 8, 32, 128, 256, 512)


def _j_make_context():
    """The reference's ``make_context``.  Its module sets a default
    ``XLA_FLAGS`` (a 512-device host platform) when imported; the import
    here leaves the environment as it was."""
    before = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = before or ""
    try:
        from repro.launch.dryrun import make_context as j_make_context
    finally:
        if before is None:
            del os.environ["XLA_FLAGS"]
        else:
            os.environ["XLA_FLAGS"] = before
    return j_make_context


@functools.lru_cache(maxsize=None)
def _params_shape(arch):
    return jax.eval_shape(build_model(get_config(arch)).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _cache_shape(arch, shape_name):
    shape = SHAPES[shape_name]
    model = build_model(get_config(arch))
    return jax.eval_shape(lambda: model.init_cache(shape.global_batch, shape.seq_len))


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), Mesh(sizes, names)


def _entry(e):
    if isinstance(e, tuple) and len(e) == 1:
        return e[0]
    return tuple(e) if isinstance(e, tuple) else e


def _norm(spec):
    if isinstance(spec, NamedSharding):
        spec = spec.spec
    return tuple(_entry(e) for e in spec)


def _j_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, NamedSharding)))
    return {tuple(k.key for k in path if hasattr(k, "key")): _norm(s) for path, s in leaves}


def _t_specs(tree):
    return {tuple(k for k in path if isinstance(k, str)): _norm(s)
            for path, s in leaves_with_paths(tree, lambda x: isinstance(x, PartitionSpec))}


def _t_shape(shape):
    return ShapeConfig(shape.name, seq_len=shape.seq_len, global_batch=shape.global_batch,
                       kind=shape.kind)


# ------------------------------------------------------------------ rules

rules_cases = pytest.mark.parametrize("mesh_name", list(MESHES))
arch_cases = pytest.mark.parametrize("arch", ARCHS)


@rules_cases
@arch_cases
def test_param_specs_match_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    shapes = _params_shape(arch)
    for pure in (False, True):
        want = _j_specs(j_sharding.param_pspec_tree(jcfg, jmesh, shapes, pure_dp=pure))
        got = _t_specs(t_sharding.param_pspec_tree(tcfg, tmesh, shapes, pure_dp=pure))
        assert got == want, pure
        assert len(got) == len(jax.tree.leaves(shapes))


@rules_cases
@arch_cases
def test_zero1_specs_match_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    shapes = _params_shape(arch)
    for quant8 in (False, True):
        opt_shape = jax.eval_shape(functools.partial(j_opt.init_opt_state, quant8=quant8), shapes)
        want = _j_specs(j_opt.zero1_shardings(jmesh, opt_shape))
        got = _t_specs(t_opt.zero1_shardings(tmesh, opt_shape))
        assert got == want, quant8
        assert len(got) == len(jax.tree.leaves(opt_shape))


@rules_cases
@arch_cases
def test_batch_cache_and_context_rules_match_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    j_make_context = _j_make_context()
    for b in BATCHES:
        assert t_sharding.pure_dp_active(tcfg, tmesh, b) == j_sharding.pure_dp_active(jcfg, jmesh, b)
        assert t_sharding.dp_axes_for(tcfg, tmesh, b) == j_sharding.dp_axes_for(jcfg, jmesh, b)
        jctx, tctx = j_make_context(jmesh, jcfg, b), make_context(tmesh, tcfg, b)
        assert (tctx.rules, tctx.ep_axes, tctx.dp_axes, tctx.tp_axis) == \
            (jctx.rules, jctx.ep_axes, jctx.dp_axes, jctx.tp_axis)
    assert t_sharding.dp_axes(tmesh) == j_sharding.dp_axes(jmesh)
    assert t_sharding.logical_rules(tmesh) == j_sharding.logical_rules(jmesh)
    for name, shape in SHAPES.items():
        want = {k: _norm(v) for k, v in j_sharding.batch_pspecs(jcfg, shape, jmesh).items()}
        got = {k: _norm(v) for k, v in t_sharding.batch_pspecs(tcfg, _t_shape(shape), tmesh).items()}
        assert got == want, name
        if shape.kind == "decode":
            cache = _cache_shape(arch, name)
            want = _j_specs(j_sharding.cache_pspec_tree(jcfg, shape, jmesh, cache))
            got = _t_specs(t_sharding.cache_pspec_tree(tcfg, _t_shape(shape), tmesh, cache))
            assert got == want, name


def test_meshes_match_the_reference_layouts():
    assert dict(make_production_mesh().shape) == {"data": 16, "model": 16}
    assert dict(make_production_mesh(multi_pod=True).shape) == {"pod": 2, "data": 16, "model": 16}
    for n, want in ((8, (2, 4)), (4, (2, 2)), (2, (1, 2)), (1, (1, 1))):
        assert tuple(make_debug_mesh(n).shape.values()) == want
    assert tuple(make_debug_mesh(8, multi_pod=True).shape.values()) == (2, 1, 4)
    assert make_debug_mesh(4).device_mesh is None          # no ranks: abstract


def test_placements_follow_the_reference_layout():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import placements

    mesh = Mesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(PartitionSpec(("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert placements(PartitionSpec(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        placements(PartitionSpec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        placements(PartitionSpec("model", "model"), mesh)


def test_init_ranks_takes_backend_and_device_explicitly():
    from repro_torch.launch.mesh import init_ranks

    with pytest.raises(ValueError, match="gloo"):
        init_ranks(0, 1, "file:///nowhere", backend="nccl", device_type="cpu")
    with pytest.raises(ValueError, match="backend"):
        init_ranks(0, 1, "file:///nowhere", backend="mpi", device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        init_ranks(0, 1, "file:///nowhere", backend="gloo", device_type="xpu")


def test_dtensor_collectives_routed_through_eager_calls(tmp_path):
    """The route ``init_ranks`` installs for gloo ranks on cards, here for
    the CPU: DTensor's all-gather, all-reduce, reduce-scatter and
    shard-to-shard moves give their values, and go through the logged
    eager calls."""
    outs = start_ranks(4, "_torch_mesh_ranks:routed_redistributions", tmp_path).results()
    full = torch.arange(64.0).reshape(8, 8)
    for out in outs:
        torch.testing.assert_close(out["full"], full)
        torch.testing.assert_close(out["resharded"], full)
        torch.testing.assert_close(out["summed"], torch.full((4, 4), 2.0).repeat(2, 1))
        assert out["scattered"].shape == (4, 2) and bool((out["scattered"] == 2.0).all())
        assert {"all_gather", "all_reduce", "reduce_scatter"} <= set(out["log"]), out["log"]


# -------------------------------------------------------------- moe_ep

MOE_CASES = {
    # id: (arch, config overrides, pure DP × EP, batch, seq)
    "tp-cf8": ("qwen2-moe-a2.7b", dict(capacity_factor=8.0), False, 8, 16),
    "tp-cf1": ("qwen2-moe-a2.7b", dict(capacity_factor=1.0), False, 8, 16),
    "pure-dp-cf8": ("qwen2-moe-a2.7b", dict(capacity_factor=8.0), True, 8, 16),
    "pure-dp-cf1": ("qwen2-moe-a2.7b", dict(capacity_factor=1.0), True, 8, 16),
    "arctic-gathered": ("arctic-480b", dict(capacity_factor=8.0), False, 8, 32),
}

_REFERENCE_MOE = """
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from jax.sharding import AxisType
from repro.configs import get_config
from repro.parallel.context import ParallelContext, default_rules
from repro.parallel.moe_parallel import moe_ep

mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
OUT = {}
for name, (arch, kw, pure, p, x) in ARGS.items():
    cfg = replace(get_config(arch).smoke(), **kw)
    ctx = ParallelContext(mesh, default_rules(False), ep_axes=("data",),
                          dp_axes=("data", "model") if pure else ("data",),
                          tp_axis=None if pure else "model")
    with mesh:
        y, aux = jax.jit(lambda p, x: moe_ep(p, x, cfg, ctx))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    # each device's own aux (the weight-gathered mode leaves each TP rank
    # the aux of its token slice under a replicated spec)
    OUT[name] = {"y": np.asarray(y), "aux": [float(s.data) for s in aux.addressable_shards]}
"""


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = {}
    for name, (arch, kw, pure, b, s) in MOE_CASES.items():
        cfg = replace(get_config(arch).smoke(), **kw)
        key = jax.random.PRNGKey(0)
        p = jax.tree.map(np.asarray, moe_params(key, cfg, jax.numpy.float32))
        x = np.random.default_rng(1).standard_normal((b, s, cfg.d_model)).astype(np.float32)
        inputs[name] = (arch, kw, pure, p, x)
    ref = start_reference(4, _REFERENCE_MOE, tmp, inputs)
    ranks = start_ranks(4, "_torch_mesh_ranks:moe_layers", tmp, list(inputs.values()))
    per_rank = ranks.results()
    port = {name: [r[i] for r in per_rank] for i, name in enumerate(inputs)}
    (jout,) = ref.results()
    return inputs, port, jout


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ep_matches_reference_moe_ep(moe_runs, case):
    inputs, port, jout = moe_runs
    arch, kw, pure, p, x = inputs[case]
    ranks, want = port[case], jout[case]
    y = ranks[0]["y"]
    scale = float(np.abs(want["y"]).max())
    np.testing.assert_allclose(y, want["y"], rtol=0, atol=2e-5 * scale)
    for r in ranks:                                     # every rank gathers the same y
        np.testing.assert_array_equal(r["y"], y)
    assert ranks[0]["aux"] == pytest.approx(float(np.mean(want["aux"])), rel=1e-5)
    drops = sum(r["drops"] for r in ranks)
    cfg = replace(t_get_config(arch).smoke(), **kw)
    if cfg.capacity_factor >= 8.0:
        assert drops == 0
        tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
        oracle = moe_reference(tp, torch.from_numpy(x), cfg).numpy()
        np.testing.assert_allclose(y, oracle, rtol=0, atol=2e-5 * scale)
    else:
        assert drops > 0          # the capacity bound bit: outputs still equal


def test_arctic_case_runs_the_weight_gathered_mode():
    from repro_torch.parallel.moe_parallel import gathers_weights

    arch, kw, _, b, s = MOE_CASES["arctic-gathered"]
    cfg = replace(t_get_config(arch).smoke(), **kw)
    ctx = ParallelContext(Mesh((2, 2), ("data", "model")), default_rules(False),
                          ep_axes=("data",), dp_axes=("data",), tp_axis="model")
    assert gathers_weights(cfg, ctx, (b, s, cfg.d_model))
    assert not gathers_weights(cfg, ctx, (2, 4, cfg.d_model))     # too few tokens
    qwen = replace(t_get_config("qwen2-moe-a2.7b").smoke(), **kw)
    assert not gathers_weights(qwen, ctx, (b, s, qwen.d_model))


# -------------------------------------------------- no context, no change


def test_hints_without_a_context_change_nothing():
    x = torch.randn(2, 3, 8)
    assert shard_hint(x, "batch", None, "embed") is x
    # a context on an abstract mesh, or a plain tensor under any context
    with parallel_context(ParallelContext(Mesh((2, 2), ("data", "model")), default_rules(False))):
        assert shard_hint(x, "batch", None, "embed") is x


@pytest.mark.parametrize("in_context", [False, True], ids=["no-context", "abstract-mesh"])
def test_moe_apply_outside_a_mesh_is_the_sorted_dispatch(in_context):
    """With no mesh to dispatch over, ``moe_apply`` is the sorted dispatch:
    equal to the dense oracle."""
    cfg = t_get_config("qwen2-moe-a2.7b").smoke()
    from repro_torch.convert import init_params

    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")["layers"][0]["moe"]
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    ctx = ParallelContext(Mesh((2, 2), ("data", "model")), default_rules(False),
                          ep_axes=("data",), dp_axes=("data",), tp_axis="model")
    if in_context:
        with parallel_context(ctx):
            y, aux = moe_apply(p, x, cfg, with_aux=True)
    else:
        y, aux = moe_apply(p, x, cfg, with_aux=True)
    torch.testing.assert_close(y, moe_reference(p, x, cfg), rtol=1e-5, atol=1e-5)
    assert torch.isfinite(aux)

"""The port's sharded trainer on four gloo CPU ranks, against the JAX
reference's sharded step and the port's own single-process step.

* A (2 data × 2 model) llama step (DP + TP, ZeRO-1 moments) and a pure
  DP × EP qwen2-moe step (``make_context``: batch over both axes, experts
  over ``data``, the all-to-all MoE).  The reference runs the same step in
  a subprocess on four forced CPU devices, on a mesh with Auto axes (under
  jax 0.9 ``jax.make_mesh`` makes Explicit axes, on which the reference's
  vocab-sharded embedding gather raises ``ShardingTypeError``).  Weights
  are the reference's init, carried across as numpy.  Bounds are
  ``test_torch_train.py``'s: loss 1e-5 relative, params 2.5e-4 absolute.
* The sharded MoE step's load-balancing loss is the mean over the DP ranks
  of each rank's router statistics (the reference's ``pmean``), not the
  statistic of the whole batch.  So the single-process step it is held to
  takes the same objective (``_torch_mesh_ranks.single_step``): the
  cross-entropy of the whole batch plus the mean of each DP shard's aux
  (the other terms are the same function).
* Elastic resume: a checkpoint written at step 42 by four ranks (2 × 2),
  restored by two (1 × 2): the step, the whole state bit for bit, and the
  next step's loss against the four ranks' own continuation.

Each test runs its ranks and the reference side by side (~10–30 s).
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from _mrope_streams import image_streams
from _torch_ranks import start_ranks, start_reference
from _torch_mesh_ranks import single_step
from repro.configs import get_config
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.launch.dryrun import make_context
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import build_model
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.train.tree import leaves_with_paths, tree_map

CPU = torch.device("cpu")
OPT = dict(lr=1e-3, warmup_steps=1)

LLAMA = ("llama3.2-1b", dict(d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
                             vocab_size=512))
QWEN_MOE = ("qwen2-moe-a2.7b", dict(n_experts=8, n_experts_padded=8, capacity_factor=8.0))

_REFERENCE_STEP = """
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import make_context
from repro.models.model import build_model
from repro.parallel.context import parallel_context
from repro.parallel.sharding import batch_pspecs, param_pspec_tree, pure_dp_active
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.step import make_train_step

arch, cfg_kw, init, batch = ARGS
cfg = replace(get_config(arch).smoke(), **cfg_kw)
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
b, s = batch["tokens"].shape
pure = pure_dp_active(cfg, mesh, b)
ctx = make_context(mesh, cfg, b)
params = jax.tree.map(jnp.asarray, init)
pspecs = param_pspec_tree(cfg, mesh, jax.eval_shape(lambda p: p, params), pure_dp=pure)
params = jax.tree.map(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), params, pspecs,
                      is_leaf=lambda x: hasattr(x, "dtype"))
bspecs = batch_pspecs(cfg, ShapeConfig("t", seq_len=s, global_batch=b, kind="train"), mesh)
jbatch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, bspecs[k])) for k, v in batch.items()}
step = make_train_step(build_model(cfg), AdamWConfig(lr=1e-3, warmup_steps=1))
with mesh, parallel_context(ctx):
    p2, o2, m = jax.jit(step)(params, init_opt_state(params), jbatch)
OUT = {"layout": (ctx.dp_axes, ctx.tp_axis), "loss": float(m["loss"]),
       "grad_norm": float(m["grad_norm"]),
       "params": jax.tree.map(lambda x: np.asarray(x, np.float32), p2)}
"""


def _init(arch, cfg_kw, seed=0):
    cfg = replace(get_config(arch).smoke(), **cfg_kw)
    return jax.tree.map(np.asarray, j_build_model(cfg).init(jax.random.PRNGKey(seed)))


def _batch(vocab, b, s=16, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :2] = -1
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32), "labels": labels}


def _assert_close(got, want, atol):
    """Leaf by leaf, the port's per-layer lists against the reference's
    tree as ``params_from_jax`` lays it out."""
    want = params_from_jax(want, CPU)
    pairs = dict(leaves_with_paths(want))
    for path, g in leaves_with_paths(got):
        np.testing.assert_allclose(np.asarray(g, np.float32), pairs[path].float().numpy(),
                                   rtol=0, atol=atol, err_msg=str(path))


def _single_step(arch, cfg_kw, init, batch, *, aux_shards=1):
    cfg = replace(t_get_config(arch).smoke(), **cfg_kw)
    return single_step(build_model(cfg), params_from_jax(init, CPU), batch, AdamWConfig(**OPT),
                       aux_shards=aux_shards)


@pytest.mark.parametrize("arch,cfg_kw,rows,layout", [
    (*LLAMA, 4, (("data",), "model")),
    (*QWEN_MOE, 8, (("data", "model"), None)),
], ids=["llama-dp-tp", "qwen2-moe-pure-dp-ep"])
def test_sharded_step_matches_reference_and_single_process(tmp_path, arch, cfg_kw, rows, layout):
    init = _init(arch, cfg_kw)
    batch = _batch(t_get_config(arch).smoke().vocab_size, rows)
    ref = start_reference(4, _REFERENCE_STEP, tmp_path, (arch, cfg_kw, init, batch))
    ranks = start_ranks(4, "_torch_mesh_ranks:train_steps", tmp_path, [(arch, cfg_kw, init, batch)])
    (port,) = ranks.results()[0]
    (jout,) = ref.results()
    assert port["layout"] == jout["layout"] == layout
    assert port["loss"] == pytest.approx(jout["loss"], rel=1e-5)
    assert port["grad_norm"] == pytest.approx(jout["grad_norm"], rel=1e-4)
    _assert_close(port["params"], jout["params"], 2.5e-4)

    moe = arch == QWEN_MOE[0]
    sp, _, sm = _single_step(arch, cfg_kw, init, batch, aux_shards=4 if moe else 1)
    assert port["loss"] == pytest.approx(float(sm["loss"]), rel=1e-5)
    assert port["grad_norm"] == pytest.approx(float(sm["grad_norm"]), rel=1e-4)
    single = dict(leaves_with_paths(sp))
    for path, g in leaves_with_paths(port["params"]):
        np.testing.assert_allclose(g, single[path].float().numpy(), rtol=0, atol=2.5e-4,
                                   err_msg=str(path))


# the other families, held to the port's single-process step (itself held
# to the reference's jitted step by test_torch_train.py); the MoE one
# (arctic: TP inside the experts, aux averaged over the 2 data ranks) at
# capacity factor 8, so that no slot drops
# (arctic's weight-gathered mode at 8 x 32 tokens: the all-gathered expert
# weights' gradients reduce-scattered, each TP rank routing its own slice)
FAMILIES = {
    name: (name, kw, 4, 16) for name, kw in (
        ("qwen3-14b", {}), ("gemma-7b", {}), ("gemma2-27b", {}),
        ("arctic-480b", dict(capacity_factor=8.0)),
        ("mamba2-130m", {}), ("zamba2-2.7b", {}),
        ("seamless-m4t-large-v2", {}), ("qwen2-vl-7b", {}))
}
FAMILIES["arctic-480b-gathered"] = ("arctic-480b", dict(capacity_factor=8.0), 8, 32)


def _family_batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "patch_stub":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        pos = image_streams(2, 2, 3, s - 8)
        batch["positions"] = np.broadcast_to(pos[:, None, :], (3, b, s)).astype(np.int32).copy()
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        if cfg.frontend == "frame_stub":
            batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    cases = {}
    for name, (arch, kw, b, s) in FAMILIES.items():
        cfg = replace(t_get_config(arch).smoke(), **kw)
        init = init_params(cfg, torch.Generator().manual_seed(5), CPU)
        cases[name] = (arch, kw, tree_map(lambda t: t.numpy(), init), _family_batch(cfg, b, s))
    out = start_ranks(4, "_torch_mesh_ranks:train_steps", tmp_path_factory.mktemp("families"),
                      list(cases.values()), timeout=120).results()[0]
    return cases, dict(zip(cases, out))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_sharded_step_of_every_family_matches_single_process(family_runs, name):
    from repro_torch.parallel.moe_parallel import gathers_weights

    cases, port = family_runs
    arch, kw, init, batch = cases[name]
    cfg = replace(t_get_config(arch).smoke(), **kw)
    moe = cfg.family == "moe"
    if moe:       # the case runs the mode its name says
        ctx = make_context(Mesh((2, 2), ("data", "model")), cfg, batch["labels"].shape[0])
        shape = batch["tokens"].shape + (cfg.d_model,)
        assert gathers_weights(cfg, ctx, shape) == name.endswith("gathered")
    # the aux of the sharded step: a mean over the 2 data ranks' tokens,
    # over 4 token slices in the gathered mode (each TP rank routes its own)
    shards = (4 if name.endswith("gathered") else 2) if moe else 1
    sp, _, sm = single_step(build_model(cfg), tree_map(torch.from_numpy, init), batch,
                            AdamWConfig(**OPT), aux_shards=shards)
    got = port[name]
    assert got["layout"] == (("data",), "model")
    assert got["loss"] == pytest.approx(float(sm["loss"]), rel=1e-5)
    assert got["grad_norm"] == pytest.approx(float(sm["grad_norm"]), rel=1e-4)
    single = dict(leaves_with_paths(sp))
    for path, g in leaves_with_paths(got["params"]):
        np.testing.assert_allclose(g, single[path].float().numpy(), rtol=0, atol=2.5e-4,
                                   err_msg=str(path))


def test_zero1_moments_are_the_single_process_moments(tmp_path):
    """The ZeRO-1 moments, gathered whole, are the single-process step's
    (the update ran on each rank's shard of them)."""
    arch, cfg_kw = LLAMA
    init = _init(arch, cfg_kw, seed=3)
    batch = _batch(cfg_kw["vocab_size"], 4, seed=3)
    (port,) = start_ranks(4, "_torch_mesh_ranks:train_steps", tmp_path,
                          [(arch, cfg_kw, init, batch)]).results()[0]
    cfg = replace(t_get_config(arch).smoke(), **cfg_kw)
    params = params_from_jax(init, CPU)
    _, opt, _ = make_train_step(build_model(cfg), AdamWConfig(**OPT))(
        params, init_opt_state(params), batch)
    for key in ("m", "v"):
        single = dict(leaves_with_paths(opt[key]))
        for path, g in leaves_with_paths(port[key]):
            np.testing.assert_allclose(g, single[path].numpy(), rtol=0, atol=1e-7,
                                       err_msg=f"{key} {path}")


def test_elastic_resume_from_four_ranks_to_two(tmp_path):
    """Save at step 42 on (2 × 2), resume on (1 × 2): the same step, the
    whole state bit-equal to the checkpoint, and the next step's loss
    within 1e-5 of the four ranks' continuation."""
    arch, cfg_kw = LLAMA
    init = _init(arch, cfg_kw, seed=7)
    batches = [_batch(cfg_kw["vocab_size"], 4, seed=s) for s in (1, 2)]
    ckpt = str(tmp_path / "elastic_ckpt")
    four = start_ranks(4, "_torch_mesh_ranks:save_then_step", tmp_path, arch, cfg_kw, init,
                       batches, ckpt, 42).results()[0]
    two = start_ranks(2, "_torch_mesh_ranks:resume_then_step", tmp_path, arch, cfg_kw, ckpt,
                      batches[1]).results()[0]
    assert four["layout"].startswith("Mesh({'data': 2, 'model': 2}")
    assert two["layout"].startswith("Mesh({'data': 1, 'model': 2}")
    assert two["step"] == 42
    assert "Shard(dim=1)" in two["sharded"]          # wq's heads split over "model"
    cfg = replace(t_get_config(arch).smoke(), **cfg_kw)
    meta = init_params(cfg, torch.Generator(), device="meta")
    step, saved = restore_checkpoint(ckpt, {"params": meta, "opt": init_opt_state(meta)},
                                     device=CPU)
    assert step == 42
    restored = dict(leaves_with_paths(two["restored"]))
    for path, leaf in leaves_with_paths(saved):
        np.testing.assert_array_equal(restored[path], leaf.numpy(), err_msg=str(path))
    assert np.isfinite(two["loss"])
    assert two["loss"] == pytest.approx(four["loss"], rel=1e-5)


def test_distribute_cuts_the_slices_distribute_tensor_cuts(tmp_path):
    """``distribute`` cuts each rank's slice itself (a host tensor reaches
    a card only as that slice): the local shard, placements and shape are
    ``distribute_tensor``'s on every rank, and a cut slice a copy."""
    outs = start_ranks(4, "_torch_mesh_ranks:distribute_cases", tmp_path).results()
    for rank, got in enumerate(outs):
        assert got == [True] * len(got), f"rank {rank}: {got}"


def test_checkpoints_across_ranks_are_written_by_rank_zero(tmp_path):
    """``AsyncCheckpointer`` and ``save_checkpoint`` on four ranks: every
    rank returns with the step committed, only rank 0 starts a write, and
    the checkpoint restores to the whole tree."""
    outs = start_ranks(4, "_torch_mesh_ranks:checkpoint_on_ranks", tmp_path,
                       str(tmp_path / "ckpt")).results()
    assert [o["async_committed"] and o["sync_committed"] for o in outs] == [True] * 4
    assert [o["wrote"] for o in outs] == [True, False, False, False]
    assert outs[0][5] and outs[0][6]

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

* Serving on a mesh (the dry-run's prefill and decode cells at smoke
  size): the prompt prefilled on (2 × 2) with the cache in
  ``cache_pspec_tree``'s layout, then greedy decode steps, held to the
  port's single-process prefill and decode (logits, greedy tokens, the
  whole cache) and to the reference's jitted prefill and decode on four
  forced CPU devices.  The cases cut the KV cache's sequence over the mesh
  (llama with one KV head, which the head axis cannot divide: partial
  softmaxes merged over the ranks; once unevenly, which the reference's
  ``device_put`` refuses, so that case is held to the port alone), run
  gemma2's sliding window past its length, carry zamba2's recurrent
  state, and run seamless's encoder and cross-attention; two feed a
  one-row prompt token by token (a batch the data axis does not divide).
  The reference's chunked attention pads the keys to a chunk multiple
  and, without a causal mask, lets the padding into the softmax, so
  seamless runs at a chunk that divides its lengths.
* A kernel config on a mesh reaches the kernels' wrappers (their plain
  routes on the CPU) as often as in one process: flash attention, RMSNorm
  and the SSD scan.
* 8-bit moments on a mesh: two steps against the single-process 8-bit
  steps (losses, grad norms, the params after the first step, and the
  stored ``q`` and row scales ``s``).

Each test runs its ranks and the reference side by side (~10–30 s).
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from _mrope_streams import image_streams
from _torch_ranks import start_ranks, start_reference
from _torch_mesh_ranks import single_step, wrapper_calls
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


# ---------------------------------------------------------------------------
# serving on a mesh
# ---------------------------------------------------------------------------

_REFERENCE_SERVE = """
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import make_context
from repro.models.model import build_model
from repro.parallel.context import parallel_context
from repro.parallel.sharding import batch_pspecs, cache_pspec_tree, param_pspec_tree

OUT = []
for arch, cfg_kw, init, batch, mesh_shape, steps, stepwise in ARGS:
    cfg = replace(get_config(arch).smoke(), **cfg_kw)
    mesh = jax.make_mesh(mesh_shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    b, s = batch["tokens"].shape
    ctx = make_context(mesh, cfg, b)
    model = build_model(cfg)
    put = lambda tree, specs: jax.tree.map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), tree, specs,
        is_leaf=lambda x: isinstance(x, P))
    params = jax.tree.map(jnp.asarray, init)
    params = put(params, param_pspec_tree(cfg, mesh, jax.eval_shape(lambda p: p, params),
                                          pure_dp=ctx.tp_axis is None))
    bspecs = batch_pspecs(cfg, ShapeConfig("serve", seq_len=s, global_batch=b, kind="prefill"),
                          mesh)
    tok_sharding = NamedSharding(mesh, bspecs["tokens"])
    rec = {"logits": [], "tokens": []}
    with mesh, parallel_context(ctx):
        dec = jax.jit(model.decode_step)
        if stepwise:
            cshape = ShapeConfig("serve", seq_len=s + steps, global_batch=b, kind="decode")
            caches = jax.eval_shape(lambda: model.init_cache(b, s + steps))
            caches = put(jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), caches),
                         cache_pspec_tree(cfg, cshape, mesh, caches))
            for t in range(s):
                one = {"tokens": jax.device_put(jnp.asarray(batch["tokens"][:, t:t + 1]),
                                                tok_sharding)}
                logits, caches = dec(params, one, caches, jnp.int32(t))
        else:
            prompt = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, bspecs[k]))
                      for k, v in batch.items()}
            logits, caches = jax.jit(lambda p, bt: model.prefill(p, bt, s + steps))(params, prompt)
        for t in range(steps):
            rec["logits"].append(np.asarray(logits, np.float32))
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            rec["tokens"].append(np.asarray(tok))
            logits, caches = dec(params, {"tokens": jax.device_put(tok[:, None], tok_sharding)},
                                 caches, jnp.int32(s + t))
        rec["logits"].append(np.asarray(logits, np.float32))
    OUT.append(rec)
"""

# name: (arch, cfg_kw, rows, prompt tokens, decode steps, stepwise prompt,
# held to the reference too)
SERVE = {
    "llama-kv1-seq-cut": ("llama3.2-1b", dict(n_kv_heads=1, attn_chunk=8), 2, 12, 4, False, True),
    "llama-kv1-uneven-cut": ("llama3.2-1b", dict(n_kv_heads=1, attn_chunk=8), 2, 12, 3, False,
                             False),
    "gemma2-window": ("gemma2-27b", dict(sliding_window=8, attn_chunk=8), 2, 16, 4, False, True),
    "zamba2-state": ("zamba2-2.7b", dict(attn_chunk=8), 2, 12, 4, False, True),
    "seamless": ("seamless-m4t-large-v2", dict(attn_chunk=4), 2, 12, 4, False, True),
    "llama-one-row-stepwise": ("llama3.2-1b", {}, 1, 5, 3, True, True),
    "zamba2-one-row-stepwise": ("zamba2-2.7b", {}, 1, 5, 3, True, True),
}
# the KV cache's sequence dim (2 of [L, B, S, KV, hd]) cut over the mesh
SEQ_CUT = ("llama-kv1-seq-cut", "llama-kv1-uneven-cut", "llama-one-row-stepwise")
SERVE_ATOL = 5e-5       # fp32 logits and cache, sharded vs one process or the reference


def _serve_case(arch, kw, rows, prompt, seed=0):
    cfg = replace(get_config(arch).smoke(), **kw)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, prompt)).astype(np.int32)}
    if cfg.frontend == "frame_stub":
        batch["frames"] = rng.standard_normal((rows, prompt, cfg.d_model)).astype(np.float32)
    return _init(arch, kw), batch


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    cases = {}
    for name, (arch, kw, rows, prompt, steps, stepwise, _) in SERVE.items():
        init, batch = _serve_case(arch, kw, rows, prompt)
        cases[name] = (arch, kw, init, batch, (2, 2), steps, stepwise)
    held = [n for n in SERVE if SERVE[n][-1]]
    ref = start_reference(4, _REFERENCE_SERVE, tmp, [cases[n] for n in held], timeout=180)
    ranks = start_ranks(4, "_torch_mesh_ranks:serve_steps", tmp, list(cases.values()),
                        timeout=180)
    port = dict(zip(cases, ranks.results()[0]))
    return cases, port, dict(zip(held, ref.results()[0]))


def _single_serve(arch, kw, init, batch, steps, stepwise, tokens):
    """The port's single-process run of a serving case, fed ``tokens`` (the
    sharded run's greedy tokens): each step's logits, the greedy tokens
    and the cache at the end."""
    cfg = replace(t_get_config(arch).smoke(), **kw)
    model = build_model(cfg)
    params = params_from_jax(init, CPU)
    b, s = batch["tokens"].shape
    logits_out, greedy = [], []
    with torch.no_grad():
        if stepwise:
            caches = model.init_cache(b, s + steps, CPU)
            for t in range(s):
                one = {"tokens": torch.as_tensor(batch["tokens"][:, t:t + 1])}
                logits, caches = model.decode_step(params, one, caches,
                                                   torch.tensor(t, dtype=torch.int32))
        else:
            prompt = {k: torch.as_tensor(v) for k, v in batch.items()}
            logits, caches = model.prefill(params, prompt, s + steps)
        for t in range(steps):
            logits_out.append(logits.numpy())
            greedy.append(torch.argmax(logits, dim=-1).to(torch.int32).numpy())
            nxt = {"tokens": torch.as_tensor(tokens[t]).reshape(b, 1)}
            logits, caches = model.decode_step(params, nxt, caches,
                                               torch.tensor(s + t, dtype=torch.int32))
        logits_out.append(logits.numpy())
    return logits_out, greedy, caches


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_serving_matches_single_process(serve_runs, name):
    cases, port, _ = serve_runs
    arch, kw, init, batch, _, steps, stepwise = cases[name]
    got = port[name]
    logits, greedy, caches = _single_serve(arch, kw, init, batch, steps, stepwise, got["tokens"])
    assert len(got["logits"]) == steps + 1
    for t, (g, w) in enumerate(zip(got["logits"], logits)):
        np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL, err_msg=f"step {t}")
    for t, (g, w) in enumerate(zip(got["tokens"], greedy)):
        np.testing.assert_array_equal(g, w, err_msg=f"greedy token, step {t}")
    single = dict(leaves_with_paths(caches))
    for path, g in leaves_with_paths(got["cache"]):
        np.testing.assert_allclose(g, single[path].float().numpy(), rtol=0, atol=SERVE_ATOL,
                                   err_msg=str(path))
    if name in SEQ_CUT:
        assert "Shard(dim=2)" in got["cache_layout"]["layers"], got["cache_layout"]


@pytest.mark.parametrize("name", [n for n in SERVE if SERVE[n][-1]])
def test_sharded_serving_matches_reference(serve_runs, name):
    _, port, ref = serve_runs
    got, want = port[name], ref[name]
    for t, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL, err_msg=f"step {t}")
    for t, (g, w) in enumerate(zip(got["tokens"], want["tokens"])):
        np.testing.assert_array_equal(g, w, err_msg=f"greedy token, step {t}")


KERNEL_SERVE = {
    "seamless": ("seamless-m4t-large-v2", ("flash_attention", "rmsnorm")),
    "zamba2": ("zamba2-2.7b", ("flash_attention", "rmsnorm", "ssd_scan")),
    "mamba2": ("mamba2-130m", ("rmsnorm", "ssd_scan")),
}


@pytest.fixture(scope="module")
def kernel_serve_runs(tmp_path_factory):
    cases = {}
    for name, (arch, _) in KERNEL_SERVE.items():
        kw = dict(attention_impl="pallas")
        init, batch = _serve_case(arch, kw, 2, 12, seed=3)
        cases[name] = (arch, kw, init, batch, (2, 2), 2, False)
    out = start_ranks(4, "_torch_mesh_ranks:kernel_serve_steps",
                      tmp_path_factory.mktemp("kernel_serve"), list(cases.values()),
                      timeout=120).results()[0]
    return cases, dict(zip(cases, out))


@pytest.mark.parametrize("name", list(KERNEL_SERVE))
def test_kernel_config_on_a_mesh_reaches_the_kernels(kernel_serve_runs, name):
    """Every attention (uncached, cross and cached), RMSNorm and SSD scan
    of a kernel config's prefill and decode on a mesh goes through the
    kernel's wrapper, as often as in one process, with the same logits —
    but the gated norm of a Mamba layer whose heads the mesh cuts (16 over
    the 2 model ranks), which reduces its sums over the ranks in plain
    PyTorch: one RMSNorm less a Mamba layer a forward."""
    cases, port = kernel_serve_runs
    arch, kw, init, batch, _, steps, stepwise = cases[name]
    got, calls = port[name]
    with wrapper_calls() as single_calls:
        logits, _, _ = _single_serve(arch, kw, init, batch, steps, stepwise, got["tokens"])
    want = dict(single_calls)
    cfg = replace(t_get_config(arch).smoke(), **kw)
    if cfg.family in ("ssm", "hybrid"):
        want["rmsnorm"] -= cfg.n_layers * (1 + steps)       # the prefill and each step
    assert calls == want
    assert all(calls.get(k, 0) > 0 for k in KERNEL_SERVE[name][1]), calls
    for t, (g, w) in enumerate(zip(got["logits"], logits)):
        np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL, err_msg=f"step {t}")


def test_quant8_steps_on_a_mesh_match_single_process(tmp_path):
    """Two sharded steps with 8-bit moments against the single-process
    8-bit steps.  The first update reads the fresh fp32 moments, so the
    params after it are held as in fp32; the stored moments are held by
    their row scales and their codes (a code may sit one step off where
    the sharded reduction order moves a value across a rounding edge).
    The params after the second step are not compared: an update reads
    ``m / (√v + eps)`` from 8-bit codes, so a ``v`` code one step off near
    zero moves that element by up to ``lr``."""
    arch, cfg_kw = LLAMA
    init = _init(arch, cfg_kw, seed=4)
    batches = [_batch(cfg_kw["vocab_size"], 4, seed=s) for s in (1, 2)]
    port = start_ranks(4, "_torch_mesh_ranks:quant8_steps", tmp_path, arch, cfg_kw, init,
                       batches).results()[0]
    cfg = replace(t_get_config(arch).smoke(), **cfg_kw)
    params = params_from_jax(init, CPU)
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT))
    opt, first = init_opt_state(params, quant8=True), None
    for t, batch in enumerate(batches):
        params, opt, m = step(params, opt, batch)
        first = first or params
        assert port["losses"][t] == pytest.approx(float(m["loss"]), rel=1e-5)
        assert port["grad_norms"][t] == pytest.approx(float(m["grad_norm"]), rel=1e-4)
    single = dict(leaves_with_paths(first))
    for path, g in leaves_with_paths(port["params"]):
        np.testing.assert_allclose(g, single[path].float().numpy(), rtol=0, atol=2.5e-4,
                                   err_msg=str(path))
    for key in ("m", "v"):
        want = dict(leaves_with_paths(opt[key]))
        off = total = 0
        for path, g in leaves_with_paths(port[key]):
            w = want[path].numpy()
            if path[-1] == "s":
                np.testing.assert_allclose(g, w, rtol=2e-4, atol=0, err_msg=f"{key} {path}")
            else:
                diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1, f"{key} {path}"
                off, total = off + int((diff > 0).sum()), total + diff.size
        assert off <= 1e-3 * total, (key, off, total)

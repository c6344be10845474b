"""The port's Mamba2 trunk on a mesh, cut by heads as the reference's rules
cut it (``parallel/sharding.py``: w_z, w_x, w_dt, conv_x, b_x, A_log, D,
dt_bias and norm_w over "model" by d_inner or the heads, out_proj by its
rows, w_B, w_C and conv_B/C whole), a batch the data axis does not
divide, and attention heads the model axis does not divide in a train
step, on the CPU.

* Work against the reference's counter: per-layer-unit FLOPs and
  collective bytes of mamba2-130m's and zamba2-2.7b's smoke configs (16
  SSM heads, 4 a rank) on a (2 data × 4 model) mesh of fake ranks, at
  prefill 8 × 64, train (forward and backward) 8 × 64 and decode 8 rows
  at 128 cached, against the reference's ``_measure`` on 8 forced CPU
  devices with Auto axes (as ``test_torch_roofline.py``; zamba2's unit is
  one segment, 2 Mamba layers and the shared block).  FLOPs within
  0.9–1.05 of the reference's (XLA also counts elementwise FLOPs, the
  port's counter only the products), collective bytes at most 1.5 times.
* No Mamba weight is gathered: zamba2 and mamba2 on four gloo ranks (2 ×
  2), a prefill, greedy decode steps and a train step's forward and
  backward, each watched at DTensor's redistributions
  (``_torch_mesh_ranks.weight_gathers``; a ``full_tensor`` of one weight
  shows that the watch sees a gather).  The update is not held to it:
  ZeRO-1 moves each weight into its moments' layout (``_zero1_spec``, the
  reference's), which for the per-head vectors and norm_w (cut over
  "model", their moments over "data") DTensor runs as a gather.
* Results on four gloo ranks (2 × 2): prefill and greedy decode held to
  the port's single process and to the reference's jitted run (logits and
  the whole cache within ``SERVE_ATOL``); one train step held to one
  process and to the reference's Auto-axes step within
  ``test_torch_train.py``'s bounds — mamba2, zamba2, and llama with 3
  heads on the 2 model ranks (the gradient of the heads merged whole
  meets the row-cut ``wo``: it is made whole before the heads are split
  out of it).  The same heads on (2 × 4) fake ranks: the dry-run's train
  cell runs (qwen3-14b, arctic-480b and qwen2-vl-7b cut 40, 56 and 28
  heads over 16).
* A batch the data axis does not divide: a 3-row prompt prefilled on (2 ×
  2), then decoded, held to one process and to the reference (before the
  port ran such a batch whole over the data axis, its prefill failed in
  DTensor's sharding propagation: "Cannot flatten unevenly sharded
  tensor: dimension 0 (size 3)").
* A kernel config on the head-cut mesh reaches the SSD-scan wrapper with
  the local head count (8 of 16), as often as one process does, and each
  Mamba layer's gated norm — a reduction over the ranks — is off the
  RMSNorm wrapper.

The reference, the port's ranks and the port's counts run side by side
(~2–3 min).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from _torch_ranks import start_ranks, start_reference
from _torch_mesh_ranks import wrapper_calls
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline_fd
from test_torch_mesh import (_REFERENCE_SERVE, OPT, SERVE_ATOL, _assert_close, _batch, _init,
                             _serve_case, _single_serve, _single_step)

ARCHS = ("mamba2-130m", "zamba2-2.7b")

# ------------------------------------------------------------ the reference's side

_REFERENCE_WORK = """
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.roofline_fd import _layer_counts, _lower_cell, _measure, _with_layers

mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
OUT = {}
for arch in ARGS["archs"]:
    cfg = get_config(arch).smoke()
    l1, l2, _ = _layer_counts(cfg)
    for kind, (shape_kind, s, b) in ARGS["kinds"].items():
        shape = ShapeConfig(shape_kind, seq_len=s, global_batch=b, kind=shape_kind)
        c1, c2 = (_measure(_lower_cell(_with_layers(cfg, n), shape, mesh, kind))
                  for n in (l1, l2))
        OUT[arch, shape_kind] = {k: c2[k] - c1[k] for k in ("flops", "coll")}
"""

_REFERENCE_STEPS = """
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import make_context
from repro.models.model import build_model
from repro.parallel.context import parallel_context
from repro.parallel.sharding import batch_pspecs, param_pspec_tree
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.step import make_train_step

OUT = []
for arch, cfg_kw, init, batch in ARGS:
    cfg = replace(get_config(arch).smoke(), **cfg_kw)
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    b, s = batch["tokens"].shape
    ctx = make_context(mesh, cfg, b)
    params = jax.tree.map(jnp.asarray, init)
    pspecs = param_pspec_tree(cfg, mesh, jax.eval_shape(lambda p: p, params))
    params = jax.tree.map(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), params,
                          pspecs, is_leaf=lambda x: hasattr(x, "dtype"))
    bspecs = batch_pspecs(cfg, ShapeConfig("t", seq_len=s, global_batch=b, kind="train"), mesh)
    jbatch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, bspecs[k]))
              for k, v in batch.items()}
    step = make_train_step(build_model(cfg), AdamWConfig(lr=1e-3, warmup_steps=1))
    with mesh, parallel_context(ctx):
        p2, o2, m = jax.jit(step)(params, init_opt_state(params), jbatch)
    OUT.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": jax.tree.map(lambda x: np.asarray(x, np.float32), p2)})
"""

WORK_KINDS = {"prefill": ("prefill", 64, 8), "train_fwdbwd": ("train", 64, 8),
              "decode": ("decode", 128, 8)}
FLOP_BAND = (0.9, 1.05)      # port / reference, per layer unit
COLL_MAX = 1.5               # port / reference, collective bytes per layer unit

# name: (arch, cfg_kw, rows, prompt tokens, decode steps); every case is held
# to one process and to the reference
SERVE = {
    "mamba2": ("mamba2-130m", {}, 2, 12, 4),
    "zamba2": ("zamba2-2.7b", dict(attn_chunk=8), 2, 12, 4),
    "llama-3-rows": ("llama3.2-1b", {}, 3, 10, 3),
    "zamba2-3-rows": ("zamba2-2.7b", dict(attn_chunk=8), 3, 10, 3),
    "mamba2-3-rows": ("mamba2-130m", {}, 3, 10, 3),
}
KERNEL_STEPS = 2


def _serve_cases():
    return {name: (arch, kw, *_serve_case(arch, kw, rows, prompt), (2, 2), steps, False)
            for name, (arch, kw, rows, prompt, steps) in SERVE.items()}


# name: (arch, cfg_kw)
TRAIN = {"mamba2-130m": ("mamba2-130m", {}), "zamba2-2.7b": ("zamba2-2.7b", {}),
         "llama-3-heads": ("llama3.2-1b", dict(n_heads=3, n_kv_heads=1))}


def _train_cases():
    return {name: (arch, kw, _init(arch, kw, seed=1),
                   _batch(t_get_config(arch).smoke().vocab_size, 4, seed=1))
            for name, (arch, kw) in TRAIN.items()}


def _kernel_cases():
    kw = dict(attention_impl="pallas")
    out = {}
    for arch in ARCHS:
        init, batch = _serve_case(arch, kw, 2, 12, seed=3)
        out[arch] = (arch, kw, init, batch, (2, 2), KERNEL_STEPS, False)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ssm")
    serve, train, kernels = _serve_cases(), _train_cases(), _kernel_cases()
    gathers = [(arch, {}, *train[arch][2:], 2) for arch in ARCHS]
    work = start_reference(8, _REFERENCE_WORK, tmp, {"archs": ARCHS, "kinds": WORK_KINDS},
                           timeout=420)
    ref_serve = start_reference(4, _REFERENCE_SERVE, tmp, list(serve.values()), timeout=420)
    ref_train = start_reference(4, _REFERENCE_STEPS, tmp, list(train.values()), timeout=420)
    ranks = start_ranks(4, "_torch_mesh_ranks:mesh_ssm_runs", tmp, list(serve.values()),
                        list(train.values()), gathers, list(kernels.values()), timeout=420)
    port_work = {}
    for arch in ARCHS:
        for kind, (shape_kind, s, b) in WORK_KINDS.items():
            r = roofline_fd.run_cell(arch, shape_kind, device="cpu", mesh_shape=(2, 4),
                                     cfg=t_get_config(arch).smoke(),
                                     shape=ShapeConfig(shape_kind, seq_len=s, global_batch=b,
                                                       kind=shape_kind))
            port_work[arch, shape_kind] = r["per_layer_unit"]
    port = ranks.results()[0]
    return {
        "serve": (serve, dict(zip(serve, port["serve"])), dict(zip(serve,
                                                                   ref_serve.results()[0]))),
        "train": (train, dict(zip(train, port["train"])), dict(zip(train,
                                                                   ref_train.results()[0]))),
        "gathers": dict(zip(ARCHS, port["gathers"])),
        "kernels": (kernels, dict(zip(kernels, port["kernels"]))),
        "work": (port_work, work.results()[0]),
    }


# ------------------------------------------------------------ the work


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_work_against_reference(runs, arch, kind):
    port, ref = runs["work"]
    got, want = port[arch, kind], ref[arch, kind]
    ratio = got["flops"] / want["flops"]
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], (ratio, got, want)
    assert got["coll"] <= COLL_MAX * want["coll"], (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_mamba_weight_is_gathered(runs, arch):
    got = runs["gathers"][arch]
    assert got["watched"] == 16 * t_get_config(arch).smoke().n_layers   # 16 weights a layer
    assert got["probe"], "the watch saw no gather of a full_tensor"
    assert got["prefill"] == got["decode"] == got["train"] == [], got
    # the update's layout moves: the 1-D weights cut over "model" only
    vectors = ("A_log", "D", "b_x", "dt_bias", "norm_w")
    assert {n.split("/")[-1] for n in got["update"]} <= set(vectors), got["update"]


# ------------------------------------------------------------ results


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_serving_matches_single_process(runs, name):
    cases, port, _ = runs["serve"]
    arch, kw, init, batch, _, steps, stepwise = cases[name]
    got = port[name]
    logits, greedy, caches = _single_serve(arch, kw, init, batch, steps, stepwise, got["tokens"])
    assert len(got["logits"]) == steps + 1
    for t, (g, w) in enumerate(zip(got["logits"], logits)):
        np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL, err_msg=f"step {t}")
    for t, (g, w) in enumerate(zip(got["tokens"], greedy)):
        np.testing.assert_array_equal(g, w, err_msg=f"greedy token, step {t}")
    from repro_torch.train.tree import leaves_with_paths

    single = dict(leaves_with_paths(caches))
    for path, g in leaves_with_paths(got["cache"]):
        np.testing.assert_allclose(g, single[path].float().numpy(), rtol=0, atol=SERVE_ATOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_serving_matches_reference(runs, name):
    _, port, ref = runs["serve"]
    got, want = port[name], ref[name]
    assert len(got["logits"]) == len(want["logits"])
    for t, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL, err_msg=f"step {t}")
    for t, (g, w) in enumerate(zip(got["tokens"], want["tokens"])):
        np.testing.assert_array_equal(g, w, err_msg=f"greedy token, step {t}")


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_step_matches_reference_and_single_process(runs, name):
    from repro_torch.train.tree import leaves_with_paths

    cases, port, ref = runs["train"]
    arch, kw, init, batch = cases[name]
    got, want = port[name], ref[name]
    assert got["layout"] == (("data",), "model")
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    _assert_close(got["params"], want["params"], 2.5e-4)
    sp, _, sm = _single_step(arch, kw, init, batch)
    assert got["loss"] == pytest.approx(float(sm["loss"]), rel=1e-5)
    assert got["grad_norm"] == pytest.approx(float(sm["grad_norm"]), rel=1e-4)
    single = dict(leaves_with_paths(sp))
    for path, g in leaves_with_paths(got["params"]):
        np.testing.assert_allclose(g, single[path].float().numpy(), rtol=0, atol=2.5e-4,
                                   err_msg=str(path))


def test_train_cell_with_heads_the_model_axis_does_not_divide():
    from repro_torch.launch import dryrun

    cfg = replace(t_get_config("qwen3-14b").smoke(), n_heads=6, n_kv_heads=2)
    r = dryrun.run_cell("qwen3-14b", "train", device="cpu", mesh_shape=(2, 4), cfg=cfg,
                        shape=ShapeConfig("train", seq_len=32, global_batch=8, kind="train"),
                        verbose=False)
    assert r["status"] == "ok" and r["flops_per_device"] > 0


# ------------------------------------------------------------ the kernels' wrappers


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_config_runs_the_scan_on_each_ranks_heads(runs, arch):
    cases, port = runs["kernels"]
    _, kw, init, batch, _, steps, stepwise = cases[arch]
    got, calls, heads = port[arch]
    with wrapper_calls() as single_calls:
        logits, _, _ = _single_serve(arch, kw, init, batch, steps, stepwise, got["tokens"])
    cfg = replace(t_get_config(arch).smoke(), **kw)
    h = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    # the SSD scan of every Mamba layer of the prefill (the decode steps
    # take the recurrent form), on 8 of the 16 heads
    assert heads == {h // 2: cfg.n_layers} and calls["ssd_scan"] == single_calls["ssd_scan"]
    # each Mamba layer's gated norm reduces over the 2 model ranks, off the
    # RMSNorm wrapper: one fewer a Mamba layer a forward
    assert calls["rmsnorm"] == single_calls["rmsnorm"] - cfg.n_layers * (1 + steps)
    assert calls.get("flash_attention", 0) == single_calls.get("flash_attention", 0)
    for t, (g, w) in enumerate(zip(got["logits"], logits)):
        np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL, err_msg=f"step {t}")

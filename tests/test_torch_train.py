"""The port's trainer against the JAX reference: the optimizer, gradient
compression, the data pipeline, checkpoints, the loss, one train step per
model family, the fault-tolerant loop and the kernel-config refusal.

Inputs come from numpy seeds; the reference's own smoke weights and
optimizer state are carried across by ``params_from_jax`` /
``opt_state_from_jax``.  Tolerances of one train step (fp32 on the CPU):
loss 1e-5 relative, grad norm 1e-4 relative, fp32 moments 1e-7 absolute
(the first moment is 0.1·g, its largest entries ~6e-3: the gradients agree
to ~1e-6 of their scale), updated params 2.5e-4 absolute, a quarter of
one step's largest move (lr = 1e-3): Adam's first step divides g by
|g| + 1e-8, so where a gradient entry sits near 1e-8 its fp32 rounding
becomes a visible share of lr (the largest seen: 1.6e-4, one entry of
qwen2-vl's w_up at accum 2).  An int8 moment may sit one quantization step (its
row scale) apart where a rounding tie falls differently.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mrope_streams import image_streams
from repro.configs import get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models.model import build_model, cross_entropy_loss, param_count
from repro.models.model import active_param_count as j_active_param_count
from repro.train import compression as j_comp
from repro.train import optimizer as j_opt
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import train as j_train
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, make_pipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import model as t_model
from repro_torch.models.model import build_model as t_build_model
from repro_torch.train import compression as t_comp
from repro_torch.train import optimizer as t_opt
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.step import make_train_step
from repro_torch.train.tree import is_quant_leaf, leaves, leaves_with_paths

CPU = torch.device("cpu")
B, S = 4, 16
FAMILIES = ["llama3.2-1b", "gemma2-27b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-2.7b",
            "seamless-m4t-large-v2", "qwen2-vl-7b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_jax(_np(tree), device=CPU)


def _assert_tree_close(t_tree, j_tree, atol, *, quant_atol=False):
    """Leaf by leaf; ``quant_atol``: int8 moments compared dequantized,
    within one quantization step."""
    ref = dict(leaves_with_paths(_t(j_tree), is_quant_leaf))
    got = dict(leaves_with_paths(t_tree, is_quant_leaf))
    assert ref.keys() == got.keys()
    for path, r in ref.items():
        g = got[path]
        if is_quant_leaf(r):
            rd, gd = r["q"].float() * r["s"], g["q"].float() * g["s"]
            step = float(torch.maximum(r["s"], g["s"]).max())
            assert float((rd - gd).abs().max()) <= step * 1.001 + atol, path
            continue
        assert g.dtype == r.dtype, path
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=0, msg=str(path))


# ---------------------------------------------------------------- optimizer


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 8)).astype(np.float32),
            "layers": [{"b": rng.standard_normal((8,)).astype(np.float32),
                        "k": rng.standard_normal((3, 4, 5)).astype(np.float32)}
                       for _ in range(2)]}


@pytest.mark.parametrize("quant8", [False, True], ids=["fp32", "quant8"])
def test_adamw_update_matches_reference(quant8):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    jp = jax.tree.map(jnp.asarray, _opt_tree(0))
    tp = _t(jp)
    js, ts = j_opt.init_opt_state(jp, quant8=quant8), t_opt.init_opt_state(tp, quant8=quant8)
    assert t_opt.is_quant_state(ts) == quant8
    for k in range(3):
        g = _opt_tree(10 + k)
        jp, js, jn = j_opt.adamw_update(j_opt.AdamWConfig(**cfg), jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tn = t_opt.adamw_update(t_opt.AdamWConfig(**cfg), tp, _t(g), ts)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        assert int(ts["step"]) == int(js["step"]) == k + 1
        _assert_tree_close(tp, jp, 1e-6)
        for key in ("m", "v"):
            _assert_tree_close(ts[key], js[key], 1e-6, quant_atol=quant8)


def test_lr_schedule_and_global_norm_match_reference():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(j_opt.lr_schedule(j_opt.AdamWConfig(**cfg), jnp.asarray(step)))
        got = float(t_opt.lr_schedule(t_opt.AdamWConfig(**cfg), torch.tensor(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), step
    assert float(t_opt.lr_schedule(t_opt.AdamWConfig(**cfg), torch.tensor(0))) == 0.0
    tree = _opt_tree(3)
    assert float(t_opt.global_norm(_t(tree))) == pytest.approx(
        float(j_opt.global_norm(jax.tree.map(jnp.asarray, tree))), rel=1e-6)


def _quadratic_losses(quant8: bool, steps=60):
    cfg = t_opt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=steps,
                            weight_decay=0.0, grad_clip=1e9)
    target = torch.linspace(-1, 1, 32).reshape(4, 8)
    params = {"w": torch.zeros((4, 8))}
    state = t_opt.init_opt_state(params, quant8=quant8)
    losses = []
    for _ in range(steps):
        params, state, _ = t_opt.adamw_update(cfg, params, {"w": params["w"] - target}, state)
        losses.append(float(torch.sum((params["w"] - target) ** 2)))
    return losses


def test_adamw_converges_and_quant8_tracks_fp32():
    l32, l8 = _quadratic_losses(False), _quadratic_losses(True)
    assert l32[-1] < 1e-3 * l32[0]
    assert l8[-1] < 1e-2 * l8[0]
    assert l8[-1] < l32[0]


# -------------------------------------------------------------- compression


def test_compression_matches_reference_with_error_feedback():
    rng = np.random.default_rng(0)
    jerr = terr = None
    for _ in range(5):
        g = {"w": rng.standard_normal((16, 64)).astype(np.float32),
             "b": rng.standard_normal((64,)).astype(np.float32),
             "s": np.float32(rng.standard_normal())}
        jc, jerr = j_comp.compress(jax.tree.map(jnp.asarray, g), jerr)
        tc, terr = t_comp.compress({k: torch.from_numpy(np.asarray(v)) for k, v in g.items()}, terr)
        for k in g:
            np.testing.assert_array_equal(tc[k]["q"].numpy(), np.asarray(jc[k]["q"]))
            np.testing.assert_allclose(tc[k]["s"].numpy(), np.asarray(jc[k]["s"]), rtol=1e-7)
            np.testing.assert_allclose(terr[k].numpy(), np.asarray(jerr[k]), atol=1e-6)
        jd, td = j_comp.decompress(jc), t_comp.decompress(tc)
        for k in g:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), atol=1e-6)
    grads = {"w": torch.zeros((16, 64)), "b": torch.zeros((64,))}
    assert t_comp.compression_ratio(grads) == pytest.approx(
        j_comp.compression_ratio({k: jnp.zeros(v.shape) for k, v in grads.items()}))


# ---------------------------------------------------------------- pipeline


@pytest.mark.parametrize("seed,step,n_hosts,host_id",
                         [(1234, 0, 1, 0), (7, 5, 2, 1), (99, 123, 4, 2)])
def test_pipeline_batches_bit_equal(seed, step, n_hosts, host_id):
    kw = dict(vocab_size=97, seq_len=16, global_batch=8, seed=seed, n_hosts=n_hosts,
              host_id=host_id)
    got, want = SyntheticCorpus(DataConfig(**kw)).batch(step), JCorpus(JDataConfig(**kw)).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["tokens"].shape == (8 // n_hosts, 16)
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_prefetcher_resumes_at_its_start_step():
    cfg = DataConfig(vocab_size=97, seq_len=8, global_batch=4)
    p = make_pipeline(cfg, start_step=3)
    try:
        for step in (3, 4):
            np.testing.assert_array_equal(next(p)["tokens"], JCorpus(JDataConfig(
                vocab_size=97, seq_len=8, global_batch=4)).batch(step)["tokens"])
    finally:
        p.stop()


# -------------------------------------------------------------- checkpoints


def _ckpt_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "layers": [{"h": torch.randn(4, 5, generator=g).to(torch.bfloat16)}]},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": {"q": torch.tensor([[-3, 5]], dtype=torch.int8), "s": torch.ones((1, 1))}},
    }


def _assert_equal_trees(a, b):
    la, lb = dict(leaves_with_paths(a)), dict(leaves_with_paths(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


def test_checkpoint_roundtrip_bf16_and_crash_safety(tmp_path):
    tree = _ckpt_tree()
    d = save_checkpoint(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["arrays"]["params/layers/0/h"]["dtype"] == "bfloat16"
    assert (d / "COMMITTED").exists()
    step, restored = restore_checkpoint(tmp_path, tree)
    assert step == 7
    _assert_equal_trees(restored, tree)
    # a crashed (uncommitted) later step is ignored
    crash = tmp_path / "step_00000009"
    crash.mkdir()
    (crash / "arrays.npz").write_bytes(b"garbage")
    assert latest_step(tmp_path) == 7
    # gc removes stale tmp dirs and keeps the committed one
    (tmp_path / "step_00000005.tmp").mkdir()
    gc_checkpoints(tmp_path, keep=3)
    assert latest_step(tmp_path) == 7
    assert not (tmp_path / "step_00000005.tmp").exists()


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"w": torch.ones((4,)), "h": torch.ones((3,), dtype=torch.bfloat16)}
    d = save_checkpoint(tmp_path, 1, tree)
    for key in ("w", "h"):
        data = dict(np.load(d / "arrays.npz"))
        clean = data[key].copy()
        data[key] = data[key] + 1          # the bf16 leaf: its bits change
        np.savez(d / "arrays.npz", **data)
        with pytest.raises(IOError, match=key):
            restore_checkpoint(tmp_path, tree)
        data[key] = clean
        np.savez(d / "arrays.npz", **data)
    restore_checkpoint(tmp_path, tree)


def test_checkpoint_gc_keeps_the_newest(tmp_path):
    tree = {"w": torch.zeros((2,))}
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, step, tree)
    gc_checkpoints(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004", "step_00000005"]


def test_async_checkpoint_snapshots_at_save(tmp_path):
    tree = _ckpt_tree()
    ck = AsyncCheckpointer(tmp_path, keep=2)
    ck.save(3, tree)
    tree["params"]["w"].add_(100.0)        # after the snapshot: not in step 3
    ck.save(4, tree)
    ck.wait()
    assert latest_step(tmp_path) == 4
    assert ck.snapshot_s is not None and ck.write_s is not None
    _, s3 = restore_checkpoint(tmp_path, tree, step=3)
    assert float(s3["params"]["w"].max()) == 11.0
    _, s4 = restore_checkpoint(tmp_path, tree)
    _assert_equal_trees(s4, tree)


# -------------------------------------------------------------------- loss


def test_cross_entropy_loss_matches_reference_with_ignored_labels():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 5] = -1
    for aux in (0.0, 1.7):
        want = cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), aux_loss=aux)
        got = t_model.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                         aux_loss=aux)
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    # every label ignored: the loss is the aux term alone
    none = -np.ones_like(labels)
    assert float(t_model.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(none),
                                            aux_loss=2.0)) == pytest.approx(0.02)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2", "arctic-480b"])
def test_param_counts_match_reference(arch):
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    assert t_model.active_param_count(tcfg) == j_active_param_count(jcfg)
    jp = build_model(jcfg.smoke()).init(jax.random.PRNGKey(0))
    assert t_model.param_count(_t(jp)) == param_count(jp)
    assert t_model.param_count_shape(tcfg.smoke()) == param_count(jp)


# -------------------------------------------------------------- train step


def _batch(cfg, seed=0, b=B, s=S, ignore=True):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "patch_stub":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        if cfg.mrope_sections:
            # a text + image-patch prompt: (t, h, w) streams that differ
            pos = image_streams(4, 2, 3, s - 10)
            batch["positions"] = np.broadcast_to(pos[:, None, :], (3, b, s)).astype(np.int32).copy()
            batch["positions"][:, 1::2] = np.arange(s, dtype=np.int32)   # text-only rows
    elif cfg.frontend == "frame_stub":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if ignore:
        batch["labels"][0, :2] = -1
    return batch


def _step_pair(arch, *, quant8, accum, **cfg_kw):
    jcfg = dataclasses.replace(get_config(arch).smoke(), **cfg_kw)
    tcfg = dataclasses.replace(t_get_config(arch).smoke(), **cfg_kw)
    jp = build_model(jcfg).init(jax.random.PRNGKey(1))
    js = j_opt.init_opt_state(jp, quant8=quant8)
    opt = dict(lr=1e-3, warmup_steps=1)
    batch = _batch(jcfg)
    jstep = jax.jit(j_make_train_step(build_model(jcfg), j_opt.AdamWConfig(**opt), accum_steps=accum))
    jnp_, jns, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(t_build_model(tcfg), t_opt.AdamWConfig(**opt), accum_steps=accum)
    ts = opt_state_from_jax(_np(js), device=CPU)
    tnp, tns, tm = tstep(_t(jp), ts, batch)
    return (jnp_, jns, jm), (tnp, tns, tm)


@pytest.mark.parametrize("quant8,accum", [(False, 1), (True, 2)], ids=["fp32-accum1", "quant8-accum2"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch, quant8, accum):
    (jp, js, jm), (tp, ts, tm) = _step_pair(arch, quant8=quant8, accum=accum)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert int(ts["step"]) == int(js["step"]) == 1
    _assert_tree_close(tp, jp, 2.5e-4)
    for key in ("m", "v"):
        _assert_tree_close(ts[key], js[key], 1e-7, quant_atol=quant8)


def _port_step(arch, *, accum=1, quant8=False, ignore=True, **cfg_kw):
    cfg = dataclasses.replace(t_get_config(arch).smoke(), **cfg_kw)
    model = t_build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), CPU)
    step = make_train_step(model, t_opt.AdamWConfig(lr=1e-3, warmup_steps=1), accum_steps=accum)
    return step(params, t_opt.init_opt_state(params, quant8=quant8), _batch(cfg, b=4, ignore=ignore))


def test_accum2_matches_accum1():
    # no ignored label: both micro-batches hold the same count of labels,
    # so the mean of their means is the whole batch's mean (params within
    # 1e-5 = lr / 100: the summation order differs, see the module note)
    p1, _, m1 = _port_step("llama3.2-1b", accum=1, ignore=False)
    p2, _, m2 = _port_step("llama3.2-1b", accum=2, ignore=False)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-5)
    for a, b in zip(leaves(p1), leaves(p2)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_remat_matches_no_remat(arch):
    pa, _, ma = _port_step(arch, remat=True)
    pb, _, mb = _port_step(arch, remat=False)
    assert float(ma["loss"]) == float(mb["loss"])
    assert float(ma["grad_norm"]) == pytest.approx(float(mb["grad_norm"]), rel=1e-6)
    for a, b in zip(leaves(pa), leaves(pb)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


# ------------------------------------------------------------- the refusal


def test_pallas_config_is_refused():
    cfg = dataclasses.replace(t_get_config("llama3.2-1b").smoke(), attention_impl="pallas")
    model = t_build_model(cfg)
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(model, t_opt.AdamWConfig())
    params = model.init(torch.Generator().manual_seed(0), CPU)
    with pytest.raises(ValueError, match="forward-only"):
        model.train_forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    ecfg = dataclasses.replace(t_get_config("seamless-m4t-large-v2").smoke(),
                               attention_impl="pallas")
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(t_build_model(ecfg), t_opt.AdamWConfig())


def test_reference_trains_pallas_only_through_its_jit_fallback():
    """What the reference does with a pallas config: eager ``jax.grad``
    through its Pallas flash kernel raises (``pallas_call`` has no
    transpose rule), while the jitted step trains, because under ``jit``
    its ``pallas`` impl falls back to ``chunked`` (its per-layer window is
    traced).  No Pallas kernel is on any training step it can take."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").smoke(), attention_impl="pallas")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, b=1, s=8).items()}

    def loss(p):
        logits, aux = model.train_forward(p, batch)
        return cross_entropy_loss(logits, batch["labels"], aux_loss=aux)

    with pytest.raises(NotImplementedError):
        jax.value_and_grad(loss)(params)
    step = jax.jit(j_make_train_step(model, j_opt.AdamWConfig()))
    _, _, m = step(params, j_opt.init_opt_state(params), batch)
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    _, _, mc = jax.jit(j_make_train_step(build_model(chunked), j_opt.AdamWConfig()))(
        params, j_opt.init_opt_state(params), batch)
    assert np.isfinite(float(m["loss"]))
    assert float(m["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-6)


# ------------------------------------------------------------------ the loop


def test_train_resume_after_preemption(tmp_path):
    cfg = t_get_config("llama3.2-1b").smoke()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    ck = str(tmp_path / "ckpt")

    t1 = TrainConfig(steps=6, checkpoint_every=3, checkpoint_dir=ck, log_every=100)
    r1 = train(cfg, data_cfg, t1, device=CPU)
    assert r1["steps_run"] == 6
    assert latest_step(ck) == 6
    assert all(np.isfinite(r1["losses"]))

    # "preemption": a new run resumes from step 6 and continues to 10
    t2 = TrainConfig(steps=10, checkpoint_every=4, checkpoint_dir=ck, log_every=100)
    r2 = train(cfg, data_cfg, t2, device=CPU)
    assert r2["steps_run"] == 4          # only steps 6..10 re-run
    assert latest_step(ck) == 10

    # the same 10 steps without the preemption reach the same params
    r3 = train(cfg, data_cfg, TrainConfig(steps=10, checkpoint_every=100,
                                          checkpoint_dir=str(tmp_path / "whole")), device=CPU)
    assert r3["losses"][6:] == pytest.approx(r2["losses"], rel=1e-6)
    for a, b in zip(leaves(r2["params"]), leaves(r3["params"])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def _nan_embeds(bad_steps):
    """A VLM batch maker (tokens → embeds from a fixed table) that poisons
    the batches of ``bad_steps`` (counted by call) with a NaN."""
    table = np.random.default_rng(5).standard_normal((512, 128)).astype(np.float32)
    calls = {"n": 0}

    def make(batch):
        embeds = table[batch["tokens"]]
        if calls["n"] in bad_steps:
            embeds[0, 0, 0] = np.nan
        calls["n"] += 1
        return {"embeds": embeds, "labels": batch["labels"]}

    return make


def test_nan_breaker_drops_steps_then_raises(tmp_path):
    cfg = t_get_config("qwen2-vl-7b").smoke()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    r = train(cfg, data_cfg, TrainConfig(steps=6, checkpoint_every=100,
                                         checkpoint_dir=str(tmp_path / "a")),
              make_batch=_nan_embeds({2, 3}), device=CPU)
    assert r["steps_run"] == 4 and all(np.isfinite(r["losses"]))
    # three non-finite losses in a row raise, in both packages (the
    # reference restores its donated state from the last checkpoint after
    # each, so it needs one: every step is checkpointed here)
    jcfg, jdata = get_config("qwen2-vl-7b").smoke(), JDataConfig(**dataclasses.asdict(data_cfg))
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        train(cfg, data_cfg, TrainConfig(steps=8, checkpoint_every=100, max_consecutive_nan=3,
                                         checkpoint_dir=str(tmp_path / "t")),
              make_batch=_nan_embeds({1, 2, 3, 4}), device=CPU)
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        j_train(jcfg, jdata, JTrainConfig(steps=8, checkpoint_every=1, max_consecutive_nan=3,
                                          checkpoint_dir=str(tmp_path / "j")),
                make_batch=_nan_embeds({1, 2, 3, 4}))
    # without a checkpoint the reference's next step meets its donated
    # buffers; the port kept its state and trained on (above)
    with pytest.raises(ValueError, match="deleted or donated"):
        j_train(jcfg, jdata, JTrainConfig(steps=6, checkpoint_every=100,
                                          checkpoint_dir=str(tmp_path / "j2")),
                make_batch=_nan_embeds({2, 3}))


def test_train_cli_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "4",
            "--checkpoint-every", "2", "--global-batch", "2", "--seq-len", "8",
            "--checkpoint-dir", str(tmp_path)]
    out = train_cli.main(argv)
    assert out["steps_run"] == 4
    assert "[train] llama3.2-1b: loss" in capsys.readouterr().out
    assert latest_step(tmp_path) == 4
    lines = Path(tmp_path, "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["step"] == 0
    out = train_cli.main(argv[:6] + ["6"] + argv[7:])
    assert out["steps_run"] == 2 and latest_step(tmp_path) == 6

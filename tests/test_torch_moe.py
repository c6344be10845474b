"""Port parity of the MoE family, on the CPU.

The same numpy inputs, and the reference's own smoke weights carried across
by ``params_from_jax``, go through the JAX reference and the port: the
grouped GEMM (the port's plain version against the reference's Pallas
kernel in interpret mode and its ``ragged_dot`` oracle), the router on the
full qwen2-moe-a2.7b config, the MoE layer (the port's sorted dispatch
against the reference's dense one-hot oracle), the fused step's logits,
the serving engine's greedy tokens with dense and paged KV, and the
parameter init.

Tolerances: the grouped GEMM 1e-4 in fp32 and 5e-2 in bf16 (as
``test_kernels.py``); router weights 1e-6 and expert ids exact; the MoE
layer 1e-5 in fp32 (the same products, summed in another order); logits
2e-3 (as ``test_torch_model.py``); greedy tokens exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.devices import tpu_slice_cluster
from repro.core.placement import PlanConfig
from repro.kernels.grouped_gemm.ops import grouped_gemm as j_grouped_gemm
from repro.kernels.grouped_gemm.ref import grouped_gemm_ref
from repro.models import moe as j_moe
from repro.models.model import build_model
from repro.serving.engine import Request, ServingEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.core.devices import h100_cluster
from repro_torch.core.placement import PlanConfig as TPlanConfig
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.launch import serve as t_serve
from repro_torch.models import moe as t_moe
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serving.engine import Request as TRequest, ServingEngine as TServingEngine

CPU = [torch.device("cpu")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(arch, **kw):
    """The reference's and the port's smoke config of ``arch``, with ``kw``."""
    return (dataclasses.replace(get_config(arch).smoke(), **kw),
            dataclasses.replace(t_get_config(arch).smoke(), **kw))


# qwen2-moe smoke has 8 of 8 experts; the variant pads 6 real experts to 8
VARIANTS = {
    "qwen2-moe": ("qwen2-moe-a2.7b", {}),
    "qwen2-moe-padded": ("qwen2-moe-a2.7b", dict(n_experts=6, n_experts_padded=8)),
    "arctic": ("arctic-480b", {}),
}


@functools.lru_cache(maxsize=None)
def _pair(variant, impl="pallas"):
    """Both smoke models of ``variant`` and the reference's weights carried
    into the port."""
    arch, kw = VARIANTS[variant]
    jcfg, tcfg = _smoke(arch, attention_impl=impl, **kw)
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol, rtol=0)


# ---------------------------------------------------------- (a) grouped GEMM
def _gg_case(m, k, n, e, sizes, seed=0):
    rng = np.random.default_rng(seed)
    if sizes is None:
        cuts = np.sort(rng.integers(0, m, e - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [m]]))
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) * 0.1).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32)


def _gg_both(x, w, sizes, dtype):
    """The port's plain output and the reference's inputs, in ``dtype``."""
    tx = torch.from_numpy(x).to(dtype)
    tw = torch.from_numpy(w).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(tx.float().numpy(), jdt)
    jw = jnp.asarray(tw.float().numpy(), jdt)
    out = gg.grouped_gemm_plain(tx, tw, torch.from_numpy(sizes))
    return out, jx, jw, jnp.asarray(sizes)


@pytest.mark.parametrize(
    "m,k,n,e,sizes",
    [
        (256, 256, 128, 4, [64, 0, 128, 64]),
        (384, 128, 256, 6, None),
        (96, 128, 128, 3, [0, 96, 0]),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_plain_matches_pallas_and_ragged_dot(m, k, n, e, sizes, dtype):
    """The cases of ``test_kernels.py::test_grouped_gemm_kernel``."""
    out, jx, jw, jgs = _gg_both(*_gg_case(m, k, n, e, sizes), dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    _close(out, j_grouped_gemm(jx, jw, jgs, interpret=True), tol)
    _close(out, grouped_gemm_ref(jx, jw, jgs), tol)
    assert out.dtype == dtype and out.shape == (m, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_plain_takes_k1408_with_empty_groups(dtype):
    """qwen2-moe's down projection depth (K = 1408, which the Pallas kernel's
    512-deep K tile refuses) with empty experts, and rows past the last
    group, which come out as zeros as in ``ragged_dot``."""
    x, w, sizes = _gg_case(40, 1408, 64, 6, [0, 7, 0, 1, 20, 0])
    out, jx, jw, jgs = _gg_both(x, w, sizes, dtype)
    _close(out, grouped_gemm_ref(jx, jw, jgs), 1e-4 if dtype == torch.float32 else 5e-2)
    assert not out[28:].any()


@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048), (1416, 2048)],
                         ids=["gate_up", "down", "k_tail"])
def test_split_k_cuts_k_in_whole_steps_and_fills_the_card_at_decode(k, n):
    """qwen2-moe's decode routing (M = 32 over 64 experts) on an H100's 132
    SMs: K is split, the splits partition [0, K) in whole 64-deep steps
    (only the last may end in a tail), and ~26 touched experts' tiles give
    at least 4 × 132 units."""
    s = gg.split_k(32, k, n, 64, 132)
    assert 1 < s <= gg.MAX_SPLITS
    ranges = gg.split_ranges(k, s)
    assert len(ranges) == s and ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo % gg.BK == 0 and hi > lo for lo, hi in ranges)
    assert all((hi - lo) % gg.BK == 0 for lo, hi in ranges[:-1])
    assert 26 * -(-n // gg.BN) * s >= 4 * 132


@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)], ids=["gate_up", "down"])
def test_split_k_leaves_chunk_routing_whole(k, n):
    """A fused chunk (M = 2048 over 64 experts) fills the card without
    splitting K."""
    assert gg.split_k(2048, k, n, 64, 132) == 1
    assert gg.split_ranges(k, 1) == [(0, k)]


def test_split_k_keeps_every_split_non_empty():
    """Over a sweep of shapes and SM counts: 1 <= S <= MAX_SPLITS, each
    split at least one step, and the kernel's cut (ceil(steps / S) a split)
    leaves no split empty."""
    for m in (1, 3, 8, 32, 47, 48, 88, 89, 200, 2048):
        for k in (8, 64, 136, 512, 1408, 1416, 2048, 8192):
            for n in (8, 200, 1408, 2048):
                for e in (1, 4, 64, 128):
                    for sms in (78, 132):
                        s = gg.split_k(m, k, n, e, sms)
                        steps = -(-k // gg.BK)
                        assert 1 <= s <= min(gg.MAX_SPLITS, steps)
                        assert (s - 1) * -(-steps // s) < steps
                        assert [hi - lo > 0 for lo, hi in gg.split_ranges(k, s)] == [True] * s


def test_grouped_gemm_wrapper_takes_plain_path_on_cpu():
    x, w, sizes = _gg_case(50, 64, 32, 5, [10, 0, 25, 5, 10])
    tx, tw, ts = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sizes)
    before = gg.launches
    out = gg.grouped_gemm(tx, tw, ts)
    assert gg.launches == before            # the CPU path never counts
    assert torch.equal(out, gg.grouped_gemm_plain(tx, tw, ts))
    assert torch.equal(out[10:35], (tx[10:35] @ tw[2]))


# ----------------------------------------------------------------- (b) router
def test_router_topk_matches_reference_on_full_qwen2_moe():
    """Full width: 2048-wide tokens, 60 real experts padded to 64, top-4."""
    jcfg, tcfg = get_config("qwen2-moe-a2.7b"), t_get_config("qwen2-moe-a2.7b")
    rng = np.random.default_rng(11)
    d, e = jcfg.d_model, jcfg.n_experts_padded
    x = rng.standard_normal((64, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    jw, je, _ = j_moe.router_topk(jnp.asarray(router), jnp.asarray(x), jcfg)
    tw, te = t_moe.router_topk(torch.from_numpy(router), torch.from_numpy(x), tcfg)
    assert te.shape == (64, 4)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tw, jw, 1e-6)
    assert int(te.max()) < jcfg.n_experts            # no padding expert chosen


# -------------------------------------------------------------- (c) the layer
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "wrapper"])
def test_moe_apply_matches_reference_oracle(variant, kernel):
    """The port's sorted dispatch (through the grouped GEMM's plain version,
    or its wrapper, which takes it on the CPU) against the reference's dense
    one-hot ``moe_reference``, in fp32; the port's own copy of the oracle
    agrees too."""
    jcfg, tcfg, jp, tp = _pair(variant)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, jcfg.d_model)).astype(np.float32)
    p_j, p_t = jp["layers"][0]["moe"], tp["layers"][0]["moe"]
    ref, _ = j_moe.moe_reference(p_j, jnp.asarray(x), jcfg)
    got = t_moe.moe_apply(p_t, torch.from_numpy(x), tcfg, kernel=kernel)
    _close(got, ref, 1e-5)
    _close(t_moe.moe_reference(p_t, torch.from_numpy(x), tcfg), ref, 1e-5)
    _, experts = t_moe.router_topk(p_t["router"], torch.from_numpy(x).reshape(21, -1), tcfg)
    assert int(experts.max()) < tcfg.n_experts


# ----------------------------------------------------------- (d) fused step
@pytest.mark.parametrize("variant", ["qwen2-moe", "arctic"])
def test_fused_step_logits_match_reference(variant):
    """One fused mixed step with ragged rows (a prefill chunk, a decode row
    deep in a written cache, an idle row): full logits and the KV writes."""
    jcfg, tcfg, jp, tp = _pair(variant)
    jm, tm = build_model(jcfg), t_build_model(tcfg)
    rng = np.random.default_rng(9)
    s, max_len = 6, 32
    toks = rng.integers(1, jcfg.vocab_size, size=(3, s)).astype(np.int32)
    cache_pos = np.asarray([0, 11, 0], np.int32)
    q_lens = np.asarray([6, 1, 0], np.int32)
    shape = np.asarray(jm.init_cache(3, max_len)["layers"]["k"]).shape
    hist = rng.standard_normal(shape).astype(np.float32)
    jc = {"layers": {k: jnp.asarray(hist) for k in ("k", "v")}}
    tc = {"layers": {k: torch.from_numpy(hist.copy()) for k in ("k", "v")}}
    jl, jc = jax.jit(jm.fused_step)(jp, {"tokens": jnp.asarray(toks)}, jc, cache_pos, q_lens)
    tl_, tc = tm.fused_step(tp, {"tokens": torch.from_numpy(toks)}, tc, cache_pos, q_lens)
    assert tl_.shape == (3, s, jcfg.vocab_size)
    _close(tl_, jl, 2e-3)
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], 1e-5)


# -------------------------------------------------------------- (e) engine
def _requests(cls):
    """Requests 0, 2 and 4 open with one 11-token prefix."""
    rng = np.random.default_rng(7)
    prefix = [int(t) for t in rng.integers(1, 200, size=11)]
    out = []
    for i in range(5):
        sfx = [int(t) for t in rng.integers(1, 200, size=int(rng.integers(1, 9)))]
        out.append(cls(rid=i, prompt=prefix + sfx if i % 2 == 0 else sfx,
                       max_new_tokens=int(rng.integers(2, 6))))
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged_shared"])
def test_engine_tokens_match_reference(paged):
    jcfg, tcfg, jp, tp = _pair("qwen2-moe")
    kv = dict(kv_page_tokens=8) if paged else {}
    kw = dict(slots=3, max_len=64, eos_id=-1, prefill_chunk=8)
    ref = ServingEngine(jcfg, jp, tpu_slice_cluster(n_slices=1),
                        plan_cfg=PlanConfig(method="etf", **kv), **kw)
    eng = TServingEngine(tcfg, tp, h100_cluster(1), devices=CPU,
                         plan_cfg=TPlanConfig(method="etf", **kv), **kw)
    jr, tr = _requests(Request), _requests(TRequest)
    for a, b in zip(jr, tr):
        ref.submit(a)
        eng.submit(b)
    ref.run_until_drained()
    eng.run_until_drained()
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and r.state == "finished" for r in tr)
    if paged:
        stats = eng._kv_pool.stats()
        assert stats["reused_pages"] >= 1 and stats == ref._kv_pool.stats()
        assert eng._kv_pool.pages_in_use() == 0


def test_serve_cli_moe_on_cpu(capsys):
    engine, reqs = t_serve.main([
        "--arch", "qwen2-moe-a2.7b", "--smoke", "--device", "cpu", "--requests", "3",
        "--max-new-tokens", "4", "--method", "etf",
    ])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    assert engine.cfg.family == "moe" and engine.cfg.attention_impl == "pallas"
    assert "[serve] qwen2-moe-a2.7b: placement=" in capsys.readouterr().out


# ---------------------------------------------------------------- (f) params
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b"])
def test_init_params_layout_matches_reference_for_moe(arch):
    """Keys, shapes, dtypes and scales of a fresh MoE init against the
    reference's: router fp32 at 1/√d, experts at 1/√d and 1/√f, the shared
    or parallel dense FFN as dense MLPs."""
    kw = dict(d_model=256, moe_d_ff=128)
    jcfg, tcfg = _smoke(arch, **kw)
    p = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    tleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), p))
    jleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    assert [k for k, _ in tleaves] == [k for k, _ in jleaves]
    assert any("router" in jax.tree_util.keystr(k) for k, _ in tleaves)
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert t.shape == j.shape and t.dtype == j.dtype, jax.tree_util.keystr(path)
        if j.ndim == 1:
            assert not t.any()
        else:
            assert abs(t.std() / j.std() - 1) < 0.1, jax.tree_util.keystr(path)


def test_params_from_jax_copies_moe_layers():
    jcfg, _, jp, tp = _pair("qwen2-moe")
    for i, layer in enumerate(tp["layers"]):
        for key in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(layer["moe"][key].numpy(),
                                          np.asarray(jp["layers"][i]["moe"][key]))
        np.testing.assert_array_equal(layer["shared_mlp"]["w_down"].numpy(),
                                      np.asarray(jp["layers"][i]["shared_mlp"]["w_down"]))
    assert tp["layers"][0]["moe"]["router"].dtype == torch.float32
    assert tp["layers"][0]["moe"]["w_gate"].shape == (jcfg.n_experts_padded, jcfg.d_model,
                                                      jcfg.moe_d_ff)

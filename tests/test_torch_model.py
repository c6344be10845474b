"""Port parity: the dense model and the stage executor against the JAX
reference, on fp32 smoke configs with the reference's own smoke weights
carried across by ``params_from_jax``.  Logits agree to atol 2e-3 (as
``test_serving.py``), greedy tokens exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.modelgraph import transformer_graph
from repro.models.model import build_model
from repro.serving.stage_executor import Stage, StageExecutor
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.models import transformer as t_transformer
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serving.stage_executor import (
    StageExecutor as TStageExecutor,
    stages_from_placement as t_stages_from_placement,
)

ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, impl):
    jcfg = dataclasses.replace(get_config(arch).smoke(), attention_impl=impl)
    tcfg = dataclasses.replace(t_get_config(arch).smoke(), attention_impl=impl)
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "arch,impl",
    [("llama3.2-1b", "chunked"), ("llama3.2-1b", "pallas"), ("qwen3-14b", "pallas"),
     ("gemma2-27b", "pallas")],
)
def test_prefill_decode_fused_match_reference(arch, impl):
    jcfg, tcfg, jp, tp = _pair(arch, impl)
    jm, tm = build_model(jcfg), t_build_model(tcfg)
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    max_len = 32

    # the reference runs jitted: one compile instead of hundreds of eager ops
    j_prefill = jax.jit(jm.prefill, static_argnums=2)
    j_decode = jax.jit(jm.decode_step)
    j_fused = jax.jit(jm.fused_step)
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(prompt)}, max_len)
    tl_, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, max_len)
    _close(tl_, jl)

    # greedy decode continuation at a scalar depth
    jt, tt_ = [], []
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl_, -1).to(torch.int32)[:, None]
    for i in range(4):
        jl, jc = j_decode(jp, {"tokens": jtok}, jc, jnp.asarray(9 + i, jnp.int32))
        tl_, tc = tm.decode_step(tp, {"tokens": ttok}, tc, torch.tensor(9 + i))
        _close(tl_, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl_, -1).to(torch.int32)[:, None]
        jt.append(np.asarray(jtok))
        tt_.append(ttok.numpy())
    assert np.array_equal(np.concatenate(jt, 1), np.concatenate(tt_, 1))

    # one fused mixed step over fresh caches: a prefill chunk, a decode row
    # deep in its cache, an idle row
    s = 6
    toks = rng.integers(1, jcfg.vocab_size, size=(3, s)).astype(np.int32)
    cache_pos = np.asarray([0, 11, 0], np.int32)
    q_lens = np.asarray([6, 1, 0], np.int32)
    jc = jm.init_cache(3, max_len)
    tc = tm.init_cache(3, max_len, device="cpu")
    # give the decode row a written history in both
    hist = rng.standard_normal(np.asarray(jc["layers"]["k"]).shape).astype(np.float32)
    jc = {"layers": {k: jnp.asarray(hist) for k in ("k", "v")}}
    tc = {"layers": {k: torch.from_numpy(hist.copy()) for k in ("k", "v")}}
    jl, jc = j_fused(jp, {"tokens": jnp.asarray(toks)}, jc, cache_pos, q_lens)
    tl_, tc = tm.fused_step(tp, {"tokens": torch.from_numpy(toks)}, tc, cache_pos, q_lens)
    _close(tl_, jl)
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], atol=1e-5)


def test_chunked_prefill_matches_whole_prefill():
    _, tcfg, _, tp = _pair("llama3.2-1b", "pallas")
    tm = t_build_model(tcfg)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(1, 500, size=(1, 21)).astype(np.int32))
    whole, _ = tm.prefill(tp, {"tokens": prompt}, 32)
    chunked, _ = tm.prefill_chunked(tp, {"tokens": prompt}, 32, chunk=8)
    torch.testing.assert_close(whole, chunked, atol=1e-5, rtol=0)
    assert int(whole.argmax()) == int(chunked.argmax())


def test_unported_families_raise():
    for arch in ("qwen2-moe-a2.7b", "mamba2-130m", "zamba2-2.7b", "seamless-m4t-large-v2"):
        with pytest.raises(NotImplementedError):
            t_build_model(t_get_config(arch).smoke())


def test_init_params_layout_and_distributions():
    cfg = dataclasses.replace(t_get_config("llama3.2-1b").smoke(), d_model=256, d_ff=512)
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jcfg = dataclasses.replace(get_config("llama3.2-1b").smoke(), d_model=256, d_ff=512)
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    tleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), p))
    jleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    assert [k for k, _ in tleaves] == [k for k, _ in jleaves]
    for (_, t), (_, j) in zip(tleaves, jleaves):
        assert t.shape == j.shape and t.dtype == j.dtype
        if j.ndim == 1:
            assert not t.any()                                   # zero norms
        else:
            # same scale as the reference init (normal · 1/√d_in, or 0.02)
            assert abs(t.std() / j.std() - 1) < 0.1


def test_executor_matches_reference_executor_two_stages():
    """A forced 2-stage placement (blocks split across two modeled
    devices) runs the same forward in both executors."""
    jcfg, tcfg, jp, tp = _pair("llama3.2-1b", "pallas")
    graph = transformer_graph(jcfg, seq_len=32, granularity="block")
    order = graph.topo_order()
    placement = {nid: (0 if i < 2 else 1) for i, nid in enumerate(order)}
    tdevs = [torch.device("cpu"), torch.device("cpu")]   # two modeled devices
    tst = t_stages_from_placement(graph, placement, tdevs, tcfg.n_layers)
    assert [s.layer_ids for s in tst] == [[0], [1]]
    # the reference's executor splits stages by device identity, and there
    # is one JAX CPU device: build its two stages from the port's split
    jst = [
        Stage(device=jax.devices()[0], layer_ids=s.layer_ids, first=s.first,
              last=s.last, node_ids=s.node_ids)
        for s in tst
    ]
    jex = StageExecutor(jcfg, jp, jst)
    tex = TStageExecutor(tcfg, tp, tst)

    toks = np.asarray([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    jc, tc = jex.init_caches(1, 32), tex.init_caches(1, 32)
    jl, jc = jex.forward(jnp.asarray(toks), jc, cache_pos=0)
    tl_, tc = tex.forward(torch.from_numpy(toks), tc, cache_pos=0)
    _close(tl_, jl)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    assert int(torch.argmax(tl_[:, -1], -1)) == int(nxt[0, 0])
    jl, _ = jex.forward(jnp.asarray(nxt), jc, cache_pos=8)
    tl_, _ = tex.forward(torch.from_numpy(nxt), tc, cache_pos=8)
    _close(tl_, jl)
    assert [len(t) for t in tex.stage_times()] == [2, 2]


def test_params_from_jax_splits_stacked_layers():
    """A ``scan_layers=True`` tree (one dict of ``[L, ...]`` arrays) becomes
    the per-layer list the port serves from."""
    jcfg = dataclasses.replace(get_config("llama3.2-1b").smoke(), scan_layers=True)
    jp = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, device="cpu")
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == jcfg.n_layers
    for i, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), jp["layers"]["attn"]["wq"][i])
        np.testing.assert_array_equal(layer["ln_mlp"].numpy(), jp["layers"]["ln_mlp"][i])
    np.testing.assert_array_equal(tp["embed"].numpy(), jp["embed"])


@pytest.mark.parametrize(
    "entry", ["init_params", "params_from_jax", "Model.init", "Model.init_cache",
              "transformer.init_cache"],
)
def test_entry_points_default_to_the_card(entry):
    """Left without a device, every entry point builds on the first card,
    and raises when there is none (the CPU is only taken on request)."""
    cfg = t_get_config("llama3.2-1b").smoke()
    gen = torch.Generator().manual_seed(0)
    calls = {
        "init_params": lambda: init_params(cfg, gen)["embed"],
        "params_from_jax": lambda: params_from_jax({"embed": np.zeros((2, 3), np.float32)})["embed"],
        "Model.init": lambda: t_build_model(cfg).init(gen)["embed"],
        "Model.init_cache": lambda: t_build_model(cfg).init_cache(1, 8)["layers"]["k"],
        "transformer.init_cache": lambda: t_transformer.init_cache(cfg, 1, 8)["layers"]["k"],
    }
    if torch.cuda.is_available():
        assert calls[entry]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            calls[entry]()

"""Port parity: ``repro_torch.models.layers`` against ``repro.models.layers``.

The same numpy inputs (seeded) go through the JAX reference and the port
at fp32 smoke sizes; tolerance atol 1e-5 (fp32, differing summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as jl
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as tl

ATOL = 1e-5

# every impl on llama; qwen3 (qk-norm) and gemma2 (window, softcap) on the
# kernel path and, for gemma2, the chunked online softmax
ATTN_CASES = [
    ("llama3.2-1b", "naive"), ("llama3.2-1b", "chunked"), ("llama3.2-1b", "pallas"),
    ("qwen3-14b", "pallas"), ("gemma2-27b", "chunked"), ("gemma2-27b", "pallas"),
    ("gemma-7b", "pallas"), ("gemma-7b-hd256", "pallas"),
]
# "<arch>-hd256": the arch's smoke config at head dim 256 (gemma-7b's),
# whose q-dim (4 x 256) is not its d_model (128)
_HD256 = "-hd256"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(
        t_out.detach().float().numpy(), np.asarray(j_out, np.float32), atol=atol, rtol=0
    )


def _cfgs(arch, **kw):
    if arch.endswith(_HD256):
        arch, kw["head_dim"] = arch[: -len(_HD256)], 256
    j = dataclasses.replace(get_config(arch).smoke(), **kw)
    t = dataclasses.replace(t_get_config(arch).smoke(), **kw)
    return j, t


def _attn_params(rng, cfg):
    hd = cfg.resolved_head_dim
    p = {
        "wq": rng.standard_normal((cfg.d_model, cfg.n_heads * hd)) / np.sqrt(cfg.d_model),
        "wk": rng.standard_normal((cfg.d_model, cfg.n_kv_heads * hd)) / np.sqrt(cfg.d_model),
        "wv": rng.standard_normal((cfg.d_model, cfg.n_kv_heads * hd)) / np.sqrt(cfg.d_model),
        "wo": rng.standard_normal((cfg.n_heads * hd, cfg.d_model)) / np.sqrt(cfg.n_heads * hd),
    }
    if cfg.qk_norm:
        p["q_norm"] = rng.standard_normal(hd) * 0.1
        p["k_norm"] = rng.standard_normal(hd) * 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("shape", [(3, 128), (2, 5, 64)])
def test_rmsnorm_matches_reference(shape, kernel):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    _close(tl.rmsnorm(_t(x), _t(w), kernel=kernel), jl.rmsnorm(jnp.asarray(x), jnp.asarray(w)))


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 6)).astype(np.int32)
    _close(
        tl.apply_rope(_t(x), _t(pos), 500000.0),
        jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0),
        atol=1e-4,   # cos/sin of angles up to ~1e3 rad differ by an fp32 ulp
    )


def test_softcap_matches_reference():
    x = np.linspace(-200, 200, 41, dtype=np.float32)
    _close(tl.softcap(_t(x), 50.0), jl.softcap(jnp.asarray(x), 50.0), atol=1e-4)
    assert tl.softcap(_t(x), None) is not None


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(2)
    p = {
        "w_gate": rng.standard_normal((32, 64)).astype(np.float32) / 6,
        "w_up": rng.standard_normal((32, 64)).astype(np.float32) / 6,
        "w_down": rng.standard_normal((64, 32)).astype(np.float32) / 8,
    }
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    _close(
        tl.mlp({k: _t(v) for k, v in p.items()}, _t(x), act),
        jl.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act),
    )


def _run_both(jcfg, tcfg, p, x, *, positions, cache=None, cache_pos=None, q_lens=None,
              window=None):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jkw, tkw = {}, {}
    if cache is not None:
        jkw["kv_cache"] = {k: jnp.asarray(v) for k, v in cache.items()}
        tkw["kv_cache"] = {k: _t(v) for k, v in cache.items()}
    if cache_pos is not None:
        jkw["cache_pos"] = jnp.asarray(cache_pos)
        tkw["cache_pos"] = _t(cache_pos)
    if q_lens is not None:
        jkw["q_lens"] = jnp.asarray(q_lens)
        tkw["q_lens"] = _t(q_lens)
    ref = jax.jit(
        lambda p_, x_, pos_, kw_: jl.multihead_attention(
            p_, x_, jcfg, positions=pos_, layer_window=window, **kw_
        )
    )
    jo, jc = ref(jp, jnp.asarray(x), jnp.asarray(positions), jkw)
    to, tc = tl.multihead_attention(
        tp, _t(x), tcfg, positions=_t(positions), layer_window=window, **tkw,
    )
    return jo, jc, to, tc


@pytest.mark.parametrize("arch,impl", ATTN_CASES)
def test_attention_no_cache(arch, impl):
    jcfg, tcfg = _cfgs(arch, attention_impl=impl, attn_chunk=16)
    rng = np.random.default_rng(3)
    p = _attn_params(rng, jcfg)
    b, s = 2, 40
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    window = 8 if jcfg.sliding_window else None
    jo, _, to, _ = _run_both(jcfg, tcfg, p, x, positions=pos, window=window)
    _close(to, jo)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_attention_dense_cache_scalar_pos(impl):
    jcfg, tcfg = _cfgs("llama3.2-1b", attention_impl=impl)
    rng = np.random.default_rng(4)
    p = _attn_params(rng, jcfg)
    b, s, smax, cp = 2, 5, 24, 7
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    cache = {
        k: rng.standard_normal((b, smax, jcfg.n_kv_heads, jcfg.resolved_head_dim)).astype(
            np.float32)
        for k in ("k", "v")
    }
    pos = np.broadcast_to(np.arange(s, dtype=np.int32) + cp, (b, s)).copy()
    jo, jc, to, tc = _run_both(
        jcfg, tcfg, p, x, positions=pos, cache=cache, cache_pos=np.int32(cp)
    )
    _close(to, jo)
    for key in ("k", "v"):
        _close(tc[key], jc[key])


@pytest.mark.parametrize("arch,impl", ATTN_CASES)
def test_attention_ragged_fused_rows(arch, impl):
    """Fused mixed batch: a full chunk at 0, a decode row, a partial chunk
    at an offset, an idle row, and a chunk near max_len whose tail would
    spill past the cache row."""
    jcfg, tcfg = _cfgs(arch, attention_impl=impl, attn_chunk=8)
    rng = np.random.default_rng(5)
    p = _attn_params(rng, jcfg)
    smax, s = 24, 6
    rows = [(0, 6), (13, 1), (9, 4), (0, 0), (20, 6)]
    b = len(rows)
    cache_pos = np.asarray([r[0] for r in rows], np.int32)
    q_lens = np.asarray([r[1] for r in rows], np.int32)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    cache = {
        k: rng.standard_normal((b, smax, jcfg.n_kv_heads, jcfg.resolved_head_dim)).astype(
            np.float32)
        for k in ("k", "v")
    }
    pos = cache_pos[:, None] + np.arange(s, dtype=np.int32)[None]
    window = 5 if jcfg.sliding_window else None
    jo, jc, to, tc = _run_both(
        jcfg, tcfg, p, x, positions=pos, cache=cache, cache_pos=cache_pos,
        q_lens=q_lens, window=window,
    )
    _close(to, jo)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    # rows beyond q_len (and the idle row) come out as exact zeros before wo:
    # their attention output is zero, so the projected rows are zero too
    out = to.numpy()
    for bi, (_, n) in enumerate(rows):
        assert not out[bi, n:].any(), f"row {bi} leaked past q_len"
    # the row near max_len wrote exactly its 4 in-range tokens
    assert np.array_equal(tc["k"][4, :20].numpy(), cache["k"][4, :20])


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_attention_ragged_decode_without_q_lens(impl):
    jcfg, tcfg = _cfgs("llama3.2-1b", attention_impl=impl)
    rng = np.random.default_rng(6)
    p = _attn_params(rng, jcfg)
    b, smax = 3, 16
    cache_pos = np.asarray([0, 7, 15], np.int32)
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    cache = {
        k: rng.standard_normal((b, smax, jcfg.n_kv_heads, jcfg.resolved_head_dim)).astype(
            np.float32)
        for k in ("k", "v")
    }
    jo, jc, to, tc = _run_both(
        jcfg, tcfg, p, x, positions=cache_pos[:, None], cache=cache,
        cache_pos=cache_pos,
    )
    _close(to, jo)
    for key in ("k", "v"):
        _close(tc[key], jc[key])


def test_write_kv_touches_only_each_rows_valid_span():
    """The in-place fused-batch KV write: row b changes exactly slots
    [cache_pos, min(cache_pos + q_len, max_len)) — also for a row whose tail
    spills past max_len and a row parked at max_len."""
    rng = np.random.default_rng(9)
    smax, sq = 10, 4
    rows = [(0, 4), (3, 2), (8, 4), (10, 4), (5, 0)]
    cache = torch.from_numpy(rng.standard_normal((len(rows), smax, 2, 8)).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal((len(rows), sq, 2, 8)).astype(np.float32))
    want = cache.clone()
    for bi, (cp, n) in enumerate(rows):
        for i in range(n):
            if cp + i < smax:
                want[bi, cp + i] = new[bi, i]
    cp = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    ql = torch.tensor([r[1] for r in rows], dtype=torch.int32)
    tl._write_kv(cache, new, cp, ql)
    assert torch.equal(cache, want)

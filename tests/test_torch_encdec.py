"""Port parity of the enc-dec family (seamless-m4t-large-v2) on the CPU,
against the JAX reference.

With the reference's smoke weights carried across by ``params_from_jax``
and the same numpy frames and tokens in both packages: ``encode``,
``prefill`` and ``prefill_chunked`` (and chunked against whole in the
port), ``decode_step`` at a scalar and at a ragged ``cache_pos``, the fused
greedy driver (the mirror of ``test_fused_step.py``'s
``test_fused_step_token_identity_encdec``), paged self-attention against
dense (``test_paged_kv.py``'s enc-dec branch), and ``init_params`` and
``params_from_jax`` against the reference's layout.  The reference runs at
``attention_impl`` ``naive`` and ``pallas`` (the Pallas kernel in interpret
mode); the port's ``pallas`` impl is its kernels' plain versions here.

Tolerances: logits atol 2e-3 (as ``test_torch_model.py``), encoder memory
and caches 1e-5 (fp32, the same products summed in another order), greedy
tokens identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import encdec as j_encdec
from repro.models.model import build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.models import encdec as t_encdec
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serving.kv_pool import KVPool

ARCH = "seamless-m4t-large-v2"
CPU = torch.device("cpu")
ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(impl):
    jcfg = dataclasses.replace(get_config(ARCH).smoke(), attention_impl=impl)
    tcfg = dataclasses.replace(t_get_config(ARCH).smoke(), attention_impl=impl)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jm, jp, t_build_model(tcfg), tp


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol, rtol=0)


def _close_caches(tc, jc, atol=1e-5):
    for part in ("self", "cross"):
        for key in ("k", "v"):
            assert tuple(tc[part][key].shape) == tuple(jc[part][key].shape), (part, key)
            _close(tc[part][key], jc[part][key], atol=atol)


def _batch(frames, tokens, lib):
    if lib == "jax":
        return {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    return {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_encode_matches_reference(impl):
    """The non-causal encoder over 37 frames (not a multiple of anything)."""
    jcfg, tcfg, _, jp, _, tp = _pair(impl)
    frames = np.random.default_rng(0).standard_normal((2, 37, jcfg.d_model)).astype(np.float32)
    jmem = jax.jit(lambda p, f: j_encdec.encode(p, f, jcfg))(jp, jnp.asarray(frames))
    tmem = t_encdec.encode(tp, torch.from_numpy(frames), tcfg)
    assert tmem.dtype == torch.float32 and tuple(tmem.shape) == (2, 37, jcfg.d_model)
    _close(tmem, jmem, atol=1e-5)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_prefill_chunked_decode_match_reference(impl):
    """``prefill``, ``prefill_chunked`` (against the reference's and against
    the port's whole pass), greedy ``decode_step`` at a scalar depth, and a
    ragged ``[B]`` depth (``test_ragged_batching.py``'s
    ``test_encdec_ragged_decode_positions``, here held to the reference's
    values, not only its shapes)."""
    jcfg, tcfg, jm, jp, tm, tp = _pair(impl)
    rng = np.random.default_rng(3)
    b, s_enc, s, max_len = 2, 11, 9, 24
    frames = rng.standard_normal((b, s_enc, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(1, jcfg.vocab_size, size=(b, s)).astype(np.int32)

    jl, jc = jax.jit(jm.prefill, static_argnums=2)(jp, _batch(frames, toks, "jax"), max_len)
    tl, tc = tm.prefill(tp, _batch(frames, toks, "torch"), max_len)
    _close(tl, jl)
    _close_caches(tc, jc)

    jlc, jcc = jm.prefill_chunked(jp, _batch(frames, toks, "jax"), max_len, chunk=4)
    tlc, tcc = tm.prefill_chunked(tp, _batch(frames, toks, "torch"), max_len, chunk=4)
    _close(tlc, jlc)
    _close_caches(tcc, jcc)
    torch.testing.assert_close(tlc, tl, atol=1e-5, rtol=0)
    assert torch.equal(tlc.argmax(-1), tl.argmax(-1))

    j_decode = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1).to(torch.int32)[:, None]
    for i in range(4):
        jl, jc = j_decode(jp, {"tokens": jtok}, jc, jnp.asarray(s + i, jnp.int32))
        tl, tc = tm.decode_step(tp, {"tokens": ttok}, tc, torch.tensor(s + i))
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl, -1).to(torch.int32)[:, None]
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _close_caches(tc, jc)

    # ragged continuation: row 0 at its depth, row 1 at a pretend depth 2
    # further on (its slots in between are unwritten zeros in both)
    nxt = np.asarray([[7], [8]], np.int32)
    pos = np.asarray([s + 4, s + 6], np.int32)
    jl, jc = j_decode(jp, {"tokens": jnp.asarray(nxt)}, jc, jnp.asarray(pos))
    tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(nxt)}, tc, torch.from_numpy(pos))
    assert tuple(tl.shape) == (b, jcfg.vocab_size)
    _close(tl, jl)
    _close_caches(tc, jc)


def _driver(model, params, prompts, max_news, cross, *, chunk, max_len, lib):
    """``test_fused_step.py``'s enc-dec fused driver: the cross K/V of one
    encoder pass (``cross``), the decoder prompts streamed from an empty
    self cache, one ``fused_step`` a step over every row (prefill chunks,
    decode rows, finished rows idle at ``q_len = 0``)."""
    b = len(prompts)
    if lib == "jax":
        caches = {"self": j_encdec.init_self_cache(model.cfg, b, max_len), "cross": cross}
        fused = jax.jit(model.fused_step)
    else:
        caches = {"self": t_encdec.init_self_cache(model.cfg, b, max_len, CPU), "cross": cross}
        fused = model.fused_step
    done, out, finished = [0] * b, [[] for _ in range(b)], [False] * b
    while not all(finished):
        s = chunk if any(done[i] < len(prompts[i]) for i in range(b) if not finished[i]) else 1
        toks = np.zeros((b, s), np.int32)
        q_lens = np.zeros(b, np.int32)
        cache_pos = np.zeros(b, np.int32)
        pf = {}
        for i in range(b):
            if finished[i]:
                continue
            if done[i] < len(prompts[i]):
                n = min(chunk, len(prompts[i]) - done[i])
                toks[i, :n] = prompts[i][done[i]:done[i] + n]
                q_lens[i], cache_pos[i], pf[i] = n, done[i], n
            else:
                toks[i, 0] = out[i][-1]
                q_lens[i] = 1
                cache_pos[i] = len(prompts[i]) + len(out[i]) - 1
        tok_in = jnp.asarray(toks) if lib == "jax" else torch.from_numpy(toks)
        logits, caches = fused(params, {"tokens": tok_in}, caches, cache_pos, q_lens)
        nxt = np.asarray(jnp.argmax(logits, -1)) if lib == "jax" else logits.argmax(-1).numpy()
        for i in range(b):
            if finished[i]:
                continue
            if i in pf:
                done[i] += pf[i]
                if done[i] == len(prompts[i]):
                    out[i].append(int(nxt[i, pf[i] - 1]))
            else:
                out[i].append(int(nxt[i, 0]))
            finished[i] = len(out[i]) >= max_news[i]
    return out


def _sequential(model, params, frames, prompt, max_new, *, chunk, max_len, page_tokens=None):
    """One request alone: ``prefill_chunked``, then ``decode_step``; dense,
    or a paged self cache through a ``KVPool`` table (as
    ``test_paged_kv.py``'s ``_greedy_paged``)."""
    kw, table = {}, None
    if page_tokens is not None:
        pool = KVPool(1, max_len, page_tokens, prefix_sharing=False)
        pool.alloc_sequence(0, list(prompt), min(len(prompt) + max_new, max_len))
        table = torch.from_numpy(pool.table_array())
        kw = dict(self_cache=model.init_paged_cache(pool.num_pages, page_tokens, 1, CPU)["self"],
                  page_table=table)
    batch = {"frames": torch.from_numpy(frames), "tokens": torch.tensor([prompt], dtype=torch.int32)}
    logits, caches = model.prefill_chunked(params, batch, max_len, chunk=chunk, **kw)
    toks = [int(logits[0].argmax())]
    pos = len(prompt)
    while len(toks) < max_new:
        logits, caches = model.decode_step(
            params, {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32)}, caches,
            torch.tensor(pos), page_table=table)
        toks.append(int(logits[0].argmax()))
        pos += 1
    return toks


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_fused_driver_matches_reference_and_sequential(impl):
    """Encoder and cross K/V once, then fused decoder steps with masked-span
    self-attention writes and zeroed cross-attention padding rows: the
    port's greedy tokens equal the reference driver's and each request
    served alone."""
    jcfg, tcfg, jm, jp, tm, tp = _pair(impl)
    rng = np.random.default_rng(1)
    max_len, chunk = 32, 4
    prompts = [[int(t) for t in rng.integers(1, 100, size=n)] for n in (9, 3, 5)]
    max_news = [3, 1, 4]
    b = len(prompts)
    frames = rng.normal(size=(b, 4, jcfg.d_model)).astype(np.float32)
    seed_toks = np.zeros((b, 1), np.int32)
    _, jseed = jm.prefill(jp, _batch(frames, seed_toks, "jax"), max_len)
    _, tseed = tm.prefill(tp, _batch(frames, seed_toks, "torch"), max_len)
    _close_caches({"self": tseed["cross"], "cross": tseed["cross"]},
                  {"self": jseed["cross"], "cross": jseed["cross"]})
    port = _driver(tm, tp, prompts, max_news, tseed["cross"], chunk=chunk, max_len=max_len,
                   lib="torch")
    assert port == _driver(jm, jp, prompts, max_news, jseed["cross"], chunk=chunk,
                           max_len=max_len, lib="jax")
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        assert port[i] == _sequential(tm, tp, frames[i:i + 1], p, m, chunk=chunk,
                                      max_len=max_len), i


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_paged_matches_dense(impl):
    """Greedy decoding through a paged self-attention cache (pages of 8,
    chunks of 5 straddling them; cross K/V dense) equals the dense cache's."""
    _, tcfg, _, _, _, tp = _pair("naive")
    tm = t_build_model(dataclasses.replace(tcfg, attention_impl=impl))
    rng = np.random.default_rng(13)
    prompt = [int(t) for t in rng.integers(1, tcfg.vocab_size, size=13)]
    frames = rng.standard_normal((1, 6, tcfg.d_model)).astype(np.float32)
    kw = dict(chunk=5, max_len=48)
    dense = _sequential(tm, tp, frames, prompt, 8, **kw)
    assert _sequential(tm, tp, frames, prompt, 8, page_tokens=8, **kw) == dense


def test_model_caches_keep_the_reference_layout():
    """``init_cache`` holds a placeholder cross cache of the self cache's
    length (replaced at prefill); ``init_paged_cache`` has no cross cache."""
    _, tcfg, jm, _, tm, _ = _pair("naive")
    tc, jc = tm.init_cache(2, 16, CPU), jm.init_cache(2, 16)
    for part in ("self", "cross"):
        for key in ("k", "v"):
            assert tuple(tc[part][key].shape) == tuple(jc[part][key].shape)
    tp_, jp_ = tm.init_paged_cache(5, 8, 2, CPU), jm.init_paged_cache(5, 8, 2)
    assert tp_["cross"] is None and jp_["cross"] is None
    assert tuple(tp_["self"]["k"].shape) == tuple(jp_["self"]["k"].shape) == (
        tcfg.n_layers, 6, 8, tcfg.n_kv_heads, tcfg.resolved_head_dim)


def test_init_params_layout_and_distributions():
    """Keys, shapes and dtypes as the reference's (``encoder``/``decoder``
    per-layer lists, ``ln_enc_final``); norms zero; every weight matrix at
    the reference's init scale — normal · 1/√d_in, 0.02 for the embedding —
    pooled over the layers, within four standard errors of a sample std."""
    kw = dict(d_model=256, d_ff=512)
    tcfg = dataclasses.replace(t_get_config(ARCH).smoke(), **kw)
    jcfg = dataclasses.replace(get_config(ARCH).smoke(), **kw)
    p = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = params_from_jax(jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(0))),
                         device="cpu")
    assert len(p["encoder"]) == jcfg.n_encoder_layers and len(p["decoder"]) == jcfg.n_layers
    tleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), p))
    jleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), jp))
    assert [k for k, _ in tleaves] == [k for k, _ in jleaves]
    pooled = {}
    for (path, t), (_, j) in zip(tleaves, jleaves):
        name = jax.tree_util.keystr(path)
        assert t.shape == j.shape and t.dtype == j.dtype, name
        if j.ndim == 1:
            assert not t.any() and not j.any(), name          # zero norms
        else:
            key = "".join(f"[{k.key!r}]" for k in path if hasattr(k, "key"))  # drop the layer
            std = 0.02 if key == "['embed']" else t.shape[-2] ** -0.5
            pooled.setdefault(key, (std, []))[1].append(t.astype(np.float32).ravel())
    assert {"['decoder']['cross_attn']['wq']", "['encoder']['attn']['wk']"} <= set(pooled)
    for key, (std, parts) in pooled.items():
        v = np.concatenate(parts)
        assert abs(v.std() / std - 1) < 4 / np.sqrt(2 * v.size), key


def test_params_from_jax_splits_stacked_encoder_and_decoder():
    """A ``scan_layers=True`` reference tree stacks ``encoder`` and
    ``decoder`` as dicts of ``[L, ...]`` arrays; the port serves per-layer
    lists, and serves them the reference's logits."""
    jcfg = dataclasses.replace(get_config(ARCH).smoke(), scan_layers=True)
    jp = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, device="cpu")
    for key, n in (("encoder", jcfg.n_encoder_layers), ("decoder", jcfg.n_layers)):
        assert isinstance(tp[key], list) and len(tp[key]) == n
    for i in range(jcfg.n_layers):
        np.testing.assert_array_equal(tp["decoder"][i]["cross_attn"]["wk"].numpy(),
                                      jp["decoder"]["cross_attn"]["wk"][i])
        np.testing.assert_array_equal(tp["encoder"][i]["ln_mlp"].numpy(),
                                      jp["encoder"]["ln_mlp"][i])
    np.testing.assert_array_equal(tp["ln_enc_final"].numpy(), jp["ln_enc_final"])
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((1, 5, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(1, jcfg.vocab_size, size=(1, 6)).astype(np.int32)
    jl, _ = build_model(jcfg).prefill(jax.tree.map(jnp.asarray, jp), _batch(frames, toks, "jax"))
    tl, _ = t_build_model(t_get_config(ARCH).smoke()).prefill(tp, _batch(frames, toks, "torch"))
    _close(tl, jl)

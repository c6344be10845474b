"""Port parity of the VLM family (qwen2-vl-7b) on the CPU, against the JAX
reference.

The vision tower is a stub in both packages: the batch carries patch and
text embeddings ``[B, S, d_model]`` and, optionally, the (t, h, w) M-RoPE
position streams ``[3, B, S]``.  With the reference's smoke weights carried
across by ``params_from_jax`` and the same numpy inputs: ``apply_mrope``
with distinct streams; ``prefill``, ``decode_step`` and ``fused_step`` at
the default streams and with Qwen2-VL-style image streams; ``prefill_chunked``
at the default streams, and its refusal of explicit streams (where the
reference fails); the fused greedy driver, dense and paged; and
``init_params``.  Two findings about the reference are pinned: its
``prefill_chunked`` breaks on explicit streams, and with a temporal stream
that is not the slot index its ``naive`` and ``pallas`` impls mask
differently (the port follows each).

The reference runs eagerly wherever its ``pallas`` impl is held: under
``jax.jit`` its per-layer window is a traced array, so its
``multihead_attention`` falls back to the ``chunked`` path and never
reaches the Pallas kernel (``src/repro/models/layers.py:391-400``), which
masks like ``naive``.

Tolerances: logits atol 2e-3 (as ``test_torch_model.py``), caches and
M-RoPE 1e-5, greedy tokens identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mrope_streams import image_streams
from repro.configs import get_config
from repro.models import layers as j_layers
from repro.models.model import build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.models import layers as t_layers
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serving.kv_pool import KVPool

ARCH = "qwen2-vl-7b"
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
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jm, jp, t_build_model(tcfg), tp


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol, rtol=0)


def _batch(emb, pos, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    batch = {"embeds": conv(emb)}
    if pos is not None:
        batch["positions"] = conv(pos)
    return batch


def test_apply_mrope_matches_reference_with_distinct_streams():
    """Each frequency section rotates by its own stream: equal to the
    reference, and not RoPE on any one stream (a wrong section split would
    show); a bad split is refused."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 50, size=(3, 2, 7)).astype(np.int32)
    sections = get_config(ARCH).smoke().mrope_sections
    j = j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    t = t_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    _close(t, j, atol=1e-5)
    for i in range(3):
        assert not torch.allclose(t, t_layers.apply_rope(torch.from_numpy(x),
                                                         torch.from_numpy(pos[i]), 1e6))
    with pytest.raises(ValueError, match="head_dim/2"):
        t_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (4, 4, 4))


@pytest.mark.parametrize("streams", ["default", "image"])
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_entry_points_match_reference(impl, streams):
    """``prefill`` of a text-image-text prompt (its own streams, or the
    default ones), greedy ``decode_step`` feeding each token's embedding,
    then one fused step over a chunk, a decode row and an idle row."""
    jcfg, tcfg, jm, jp, tm, tp = _pair(impl)
    rng = np.random.default_rng(5)
    pos1 = image_streams(3, 2, 3, 4)
    b, s, max_len = 2, pos1.shape[1], 32
    emb = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(pos1[:, None], (3, b, s)).astype(np.int32) if streams == "image" else None

    jl, jc = jm.prefill(jp, _batch(emb, pos, "jax"), max_len)
    tl, tc = tm.prefill(tp, _batch(emb, pos, "torch"), max_len)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], atol=1e-5)

    j_decode = jm.decode_step
    jtok = np.asarray(jnp.argmax(jl, -1))
    ttok = tl.argmax(-1).numpy()
    for i in range(3):
        assert np.array_equal(ttok, jtok)
        e = np.asarray(jp["embed"])[jtok][:, None]
        jl, jc = j_decode(jp, {"embeds": jnp.asarray(e)}, jc, jnp.asarray(s + i, jnp.int32))
        tl, tc = tm.decode_step(tp, {"embeds": torch.from_numpy(e)}, tc, torch.tensor(s + i))
        _close(tl, jl)
        jtok, ttok = np.asarray(jnp.argmax(jl, -1)), tl.argmax(-1).numpy()
    assert np.array_equal(ttok, jtok)

    e = rng.standard_normal((3, 5, jcfg.d_model)).astype(np.float32)
    cache_pos, q_lens = np.asarray([0, 9, 0], np.int32), np.asarray([5, 1, 0], np.int32)
    jl, jc = jm.fused_step(jp, {"embeds": jnp.asarray(e)}, jm.init_cache(3, max_len),
                           jnp.asarray(cache_pos), jnp.asarray(q_lens))
    tl, tc = tm.fused_step(tp, {"embeds": torch.from_numpy(e)}, tm.init_cache(3, max_len, CPU),
                           cache_pos, q_lens)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], atol=1e-5)


def test_prefill_chunked_default_streams_and_refused_explicit_streams():
    """At the default streams, chunked prefill equals the reference's and
    the port's whole pass.  With explicit streams the reference slices the
    embeddings per chunk but not the positions and fails inside M-RoPE
    (``TypeError``); the port refuses up front (``ValueError``)."""
    jcfg, tcfg, jm, jp, tm, tp = _pair("pallas")
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((1, 12, jcfg.d_model)).astype(np.float32)
    jl, jc = jm.prefill_chunked(jp, _batch(emb, None, "jax"), 16, chunk=4)
    tl, tc = tm.prefill_chunked(tp, _batch(emb, None, "torch"), 16, chunk=4)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], atol=1e-5)
    whole, _ = tm.prefill(tp, _batch(emb, None, "torch"), 16)
    torch.testing.assert_close(tl, whole, atol=1e-5, rtol=0)

    pos = image_streams(3, 2, 3, 3)[:, None].astype(np.int32)
    with pytest.raises(TypeError):
        jm.prefill_chunked(jp, _batch(emb, pos, "jax"), 16, chunk=4)
    with pytest.raises(ValueError, match="transformer.py:579-581"):
        tm.prefill_chunked(tp, _batch(emb, pos, "torch"), 16, chunk=4)


def test_naive_and_kernel_paths_mask_differently_on_an_image():
    """A 2 × 3 image whose six patches share t = 4: the ``naive`` impl masks
    causally by the temporal stream against slot indices, the kernel path
    (``pallas``) by slot.  The port follows each impl of the reference, and
    the two impls disagree."""
    rng = np.random.default_rng(7)
    pos1 = image_streams(4, 2, 3, 2)
    assert (pos1[0, 4:10] == 4).all()
    emb = rng.standard_normal((1, pos1.shape[1], 128)).astype(np.float32)
    pos = pos1[:, None].astype(np.int32)
    out = {}
    for impl in ("naive", "pallas"):
        _, _, jm, jp, tm, tp = _pair(impl)
        jl, _ = jm.prefill(jp, _batch(emb, pos, "jax"), 16)
        tl, _ = tm.prefill(tp, _batch(emb, pos, "torch"), 16)
        _close(tl, jl)
        out[impl] = tl
    assert (out["naive"] - out["pallas"]).abs().max() > 0.1


def _driver(model, params, prompts, max_news, *, chunk, max_len, lib, page_tokens=None):
    """The fused greedy driver (``test_fused_step.py``'s
    ``_fused_generate``) on embeddings at the default streams: each row's
    tokens go in as ``params["embed"][token]``.  ``page_tokens``: a paged
    KV cache through one ``KVPool`` table for all rows (torch only)."""
    b = len(prompts)
    table = None
    if lib == "jax":
        caches, fused = model.init_cache(b, max_len), model.fused_step
        embed = np.asarray(params["embed"])
    elif page_tokens is None:
        caches, fused = model.init_cache(b, max_len, CPU), model.fused_step
        embed = params["embed"].numpy()
    else:
        pool = KVPool(b, max_len, page_tokens, prefix_sharing=False)
        for i, (p, m) in enumerate(zip(prompts, max_news)):
            pool.alloc_sequence(i, list(p), min(len(p) + m, max_len))
        caches = model.init_paged_cache(pool.num_pages, page_tokens, b, CPU)
        table, fused = torch.from_numpy(pool.table_array()), model.fused_step
        embed = params["embed"].numpy()
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
        if lib == "jax":
            logits, caches = fused(params, {"embeds": jnp.asarray(embed[toks])}, caches,
                                   jnp.asarray(cache_pos), jnp.asarray(q_lens))
            nxt = np.asarray(jnp.argmax(logits, -1))
        else:
            kw = {} if table is None else {"page_table": table}
            logits, caches = fused(params, {"embeds": torch.from_numpy(embed[toks])}, caches,
                                   cache_pos, q_lens, **kw)
            nxt = logits.argmax(-1).numpy()
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


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_fused_driver_matches_reference_dense_and_paged(impl):
    """Mixed prefill/decode/idle rows of embeddings at the default streams:
    the port's greedy tokens equal the reference's, dense and through pages
    of 8 (chunks of 4 straddling them)."""
    jcfg, tcfg, jm, jp, tm, tp = _pair(impl)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, 180, size=int(rng.integers(1, 13)))]
               for _ in range(3)]
    max_news = [int(rng.integers(1, 6)) for _ in range(3)]
    kw = dict(chunk=4, max_len=32)
    port = _driver(tm, tp, prompts, max_news, lib="torch", **kw)
    assert port == _driver(jm, jp, prompts, max_news, lib="jax", **kw)
    assert port == _driver(tm, tp, prompts, max_news, lib="torch", page_tokens=8, **kw)


def test_init_params_layout_and_distributions():
    """The dense layout (keys, shapes, dtypes as the reference's), norms
    zero, weights at the reference's scale."""
    kw = dict(d_model=256, d_ff=512)
    tcfg = dataclasses.replace(t_get_config(ARCH).smoke(), **kw)
    jcfg = dataclasses.replace(get_config(ARCH).smoke(), **kw)
    p = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    tleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), p))
    jleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    assert [k for k, _ in tleaves] == [k for k, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert t.shape == j.shape and t.dtype == j.dtype, jax.tree_util.keystr(path)
        if j.ndim == 1:
            assert not t.any()
        else:
            assert abs(t.std() / j.std() - 1) < 0.1, jax.tree_util.keystr(path)

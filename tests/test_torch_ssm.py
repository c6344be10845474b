"""Port parity of the SSM (mamba2-130m) and hybrid (zamba2-2.7b) families,
on the CPU, against the JAX reference.

The same numpy inputs go through both packages: the SSD scan's plain
version against the reference's jnp ``ssd_chunked`` and its Pallas kernel
in interpret mode; ``mamba2_block``'s three paths (fresh prefill, chunk
continuation with ragged ``seq_lens``, the single-token step with idle
rows); and, with the reference's smoke weights carried across by
``params_from_jax``, the model façade's ``prefill``, ``decode_step``,
``prefill_chunked`` and ``fused_step``, the fused greedy driver, and zamba2
through paged KV against dense.  The engine refuses both families, as the
reference's executor cannot serve them.

Tolerances: the SSD scan as ``test_kernels.py`` holds the Pallas kernel
(max error over max |ref| under 1e-5 in fp32, 4e-2 in bf16); block outputs
and states 1e-5 (fp32; the same products summed in another order); model
logits atol 1e-4 and caches 1e-5; greedy tokens identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_pallas
from repro.models import ssm as j_ssm
from repro.models.model import build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.core.devices import h100_cluster
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.models import ssm as t_ssm
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serving.engine import ServingEngine as TServingEngine
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.stage_executor import Stage as TStage, StageExecutor as TStageExecutor

ARCHS = ("mamba2-130m", "zamba2-2.7b")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(out, ref) -> float:
    """Max abs error over max |ref| (the reference kernel test's measure)."""
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out, np.float32)
    ref = np.asarray(ref.float() if isinstance(ref, torch.Tensor) else ref, np.float32)
    return float(np.abs(out - ref).max()) / (float(np.abs(ref).max()) + 1e-9)


def _both(a, dtype):
    """The same numpy data as a torch tensor of ``dtype`` and a JAX array of
    the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return t, jnp.asarray(t.float().numpy(), jdt)


# ---------------------------------------------------------------- SSD scan
SSD_SHAPES = [
    (2, 64, 4, 16, 1, 32, 16),
    (1, 128, 8, 64, 2, 64, 32),
    (2, 50, 4, 16, 4, 32, 16),     # padding path
]


def _ssd_inputs(shape, dtype, seed=0, init=False):
    """(torch args, jax args) of the reference kernel test's distributions;
    x/B/C in ``dtype``, dt/A (and the initial state) fp32."""
    bsz, s, h, p, g, n, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p))
    dt = (np.abs(rng.standard_normal((bsz, s, h))) * 0.1 + 0.01).astype(np.float32)
    a = (-(np.abs(rng.standard_normal(h)) + 0.5)).astype(np.float32)
    b = rng.standard_normal((bsz, s, g, n))
    c = rng.standard_normal((bsz, s, g, n))
    tx, jx = _both(x, dtype)
    tb, jb = _both(b, dtype)
    tc, jc = _both(c, dtype)
    targs = [tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc]
    jargs = [jx, jnp.asarray(dt), jnp.asarray(a), jb, jc]
    st = rng.standard_normal((bsz, h, p, n)).astype(np.float32) if init else None
    return targs, jargs, st


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_plain_matches_reference_and_pallas(shape, dtype):
    chunk = shape[-1]
    targs, jargs, _ = _ssd_inputs(shape, dtype)
    y, st = t_ssd.ssd_scan_plain(*targs, chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 4e-2
    for name, (yr, sr) in (
        ("ssd_chunked", j_ssm.ssd_chunked(*jargs, chunk)),
        ("pallas", j_ssd_pallas(*jargs, chunk=chunk, interpret=True)),
    ):
        assert _rel(y, yr) < tol, name
        assert _rel(st, sr) < tol, name


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_plain_init_state_matches_reference(shape):
    chunk = shape[-1]
    targs, jargs, st0 = _ssd_inputs(shape, torch.float32, seed=1, init=True)
    y, st = t_ssd.ssd_scan_plain(*targs, chunk, init_state=torch.from_numpy(st0))
    yr, sr = j_ssm.ssd_chunked(*jargs, chunk, init_state=jnp.asarray(st0))
    assert _rel(y, yr) < 1e-5
    assert _rel(st, sr) < 1e-5


def test_ssd_scan_wrapper_takes_plain_path_on_cpu():
    targs, _, st0 = _ssd_inputs(SSD_SHAPES[2], torch.float32, init=True)
    init = torch.from_numpy(st0)
    before = t_ssd.launches
    y, st = t_ssd.ssd_scan(*targs, 16, init)
    yp, sp = t_ssd.ssd_scan_plain(*targs, 16, init)
    assert torch.equal(y, yp) and torch.equal(st, sp)
    assert t_ssd.launches == before


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "wrapper"])
@pytest.mark.parametrize("target", ["fresh", "init_state"])
def test_ssd_chunked_writes_the_final_state_into_out_state(kernel, target):
    """``out_state`` receives the final state, also when it is the initial
    state itself (the model's cache updated in place)."""
    targs, _, st0 = _ssd_inputs(SSD_SHAPES[1], torch.float32, seed=2, init=True)
    init = torch.from_numpy(st0)
    yr, sr = t_ssd.ssd_scan_plain(*targs, 32, init.clone())
    out = init if target == "init_state" else torch.full_like(init, float("nan"))
    y, st = t_ssm.ssd_chunked(*targs, 32, init, kernel=kernel, out_state=out)
    assert st is out
    assert torch.equal(y, yr) and torch.equal(out, sr)


# ------------------------------------------------------------ mamba2_block
def _block_pair(ngroups):
    jcfg = dataclasses.replace(get_config("mamba2-130m").smoke(), ngroups=ngroups)
    tcfg = dataclasses.replace(t_get_config("mamba2-130m").smoke(), ngroups=ngroups)
    jp = j_ssm.mamba2_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    # the zero conv biases would hide a misplaced bias: make them random
    rng = np.random.default_rng(5)
    jp = dict(jp, **{k: jnp.asarray(rng.standard_normal(jp[k].shape) * 0.1, jnp.float32)
                     for k in ("b_x", "b_B", "b_C")})
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("ngroups", [1, 2])
@pytest.mark.parametrize(
    "path", ["prefill", "continuation", "continuation_ragged", "step", "step_idle_rows"]
)
def test_mamba2_block_paths_match_reference(path, ngroups):
    jcfg, tcfg, jp, tp = _block_pair(ngroups)
    rng = np.random.default_rng(11)
    s = {"prefill": 37, "continuation": 21, "continuation_ragged": 21}.get(path, 1)
    b = 3
    xin = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    state = seq_lens = None
    if path != "prefill":
        st0 = j_ssm.mamba2_init_state(jcfg, b, jnp.float32)
        state = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in st0.items()}
    if path == "continuation_ragged":
        seq_lens = np.asarray([21, 0, 2], np.int32)
    elif path == "step_idle_rows":
        seq_lens = np.asarray([1, 0, 1], np.int32)
    jout, jst = j_ssm.mamba2_block(
        jp, jnp.asarray(xin), jcfg,
        state=None if state is None else {k: jnp.asarray(v) for k, v in state.items()},
        seq_lens=None if seq_lens is None else jnp.asarray(seq_lens),
    )
    tout, tst = t_ssm.mamba2_block(
        tp, torch.from_numpy(xin), tcfg,
        state=None if state is None else {k: torch.from_numpy(v.copy()) for k, v in state.items()},
        seq_lens=None if seq_lens is None else torch.from_numpy(seq_lens),
        kernel=True,
    )
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    assert sorted(tst) == sorted(jst)
    for k in jst:
        assert tst[k].dtype == torch.float32 and tuple(tst[k].shape) == jst[k].shape, k
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    if path == "step_idle_rows":                       # the idle row is untouched
        for k in state:
            np.testing.assert_array_equal(tst[k][1].numpy(), state[k][1], err_msg=k)


# ------------------------------------------------------------- the façade
@functools.lru_cache(maxsize=None)
def _pair(arch, impl="pallas"):
    jcfg = dataclasses.replace(get_config(arch).smoke(), attention_impl=impl)
    tcfg = dataclasses.replace(t_get_config(arch).smoke(), attention_impl=impl)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jm, jp, t_build_model(tcfg), tp


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close_caches(tc, jc, atol=1e-5):
    tl, jl = dict(_leaves(tc)), dict(_leaves(jc))
    assert sorted(tl) == sorted(jl)
    for k in jl:
        assert tuple(tl[k].shape) == tuple(jl[k].shape), k
        np.testing.assert_allclose(tl[k].float().numpy(), np.asarray(jl[k], np.float32),
                                   atol=atol, rtol=0, err_msg=k)


def _close(t, j, atol=1e-4):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_chunked_fused_match_reference(arch):
    jcfg, tcfg, jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(7)
    b, s, max_len = 3, 19, 40
    prompt = rng.integers(1, jcfg.vocab_size, size=(b, s)).astype(np.int32)

    j_prefill = jax.jit(jm.prefill, static_argnums=2)
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(prompt)}, max_len)
    tl_, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, max_len)
    _close(tl_, jl)
    _close_caches(tc, jc)

    # chunked prefill: the recurrent state and conv tails carry across
    jlc, jcc = jm.prefill_chunked(jp, {"tokens": jnp.asarray(prompt)}, max_len, chunk=5)
    tlc, tcc = tm.prefill_chunked(tp, {"tokens": torch.from_numpy(prompt)}, max_len, chunk=5)
    _close(tlc, jlc)
    _close_caches(tcc, jcc)
    assert np.array_equal(tlc.argmax(-1).numpy(), np.asarray(jnp.argmax(jl, -1)))

    # greedy decode at a scalar depth
    j_decode = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl_, -1).to(torch.int32)[:, None]
    for i in range(4):
        jl, jc = j_decode(jp, {"tokens": jtok}, jc, jnp.asarray(s + i, jnp.int32))
        tl_, tc = tm.decode_step(tp, {"tokens": ttok}, tc, torch.tensor(s + i))
        _close(tl_, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl_, -1).to(torch.int32)[:, None]
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _close_caches(tc, jc)

    # one fused step from those caches: a 6-token chunk, a decode row, an
    # idle row (its state and KV must not move)
    toks = rng.integers(1, jcfg.vocab_size, size=(b, 6)).astype(np.int32)
    cache_pos = np.asarray([s + 4, s + 4, s + 4], np.int32)
    q_lens = np.asarray([6, 1, 0], np.int32)
    jl, jc = jax.jit(jm.fused_step)(jp, {"tokens": jnp.asarray(toks)}, jc, cache_pos, q_lens)
    idle_before = {k: v[:, 2].clone() for k, v in _leaves(tc)}    # every leaf is [L, B, ...]
    tl_, tc = tm.fused_step(tp, {"tokens": torch.from_numpy(toks)}, tc, cache_pos, q_lens)
    _close(tl_, jl)
    _close_caches(tc, jc)
    for k, v in _leaves(tc):
        assert torch.equal(v[:, 2], idle_before[k]), k


def _driver(model, params, prompts, max_news, *, chunk, max_len, lib):
    """Model-level fused greedy serving (``test_fused_step.py``'s
    ``_fused_generate``): one ``fused_step`` per step over every row —
    prefill rows stream their next chunk, decode rows feed their last
    token, finished rows idle at ``q_len = 0``; S = 1 once every row
    decodes.  ``lib`` is "jax" or "torch"."""
    b = len(prompts)
    caches = model.init_cache(b, max_len) if lib == "jax" else model.init_cache(b, max_len, CPU)
    fused = jax.jit(model.fused_step) if lib == "jax" else model.fused_step
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


def _sequential(model, params, prompt, max_new, *, chunk, max_len):
    """One request served alone: chunked prefill, then 1-token decode."""
    logits, caches = model.prefill_chunked(
        params, {"tokens": torch.tensor([prompt], dtype=torch.int32)}, max_len, chunk=chunk)
    toks = [int(logits[0].argmax())]
    pos = len(prompt)
    while len(toks) < max_new:
        logits, caches = model.decode_step(
            params, {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32)}, caches,
            torch.tensor(pos))
        toks.append(int(logits[0].argmax()))
        pos += 1
    return toks


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_driver_matches_reference_and_sequential(arch):
    """Mixed prefill/decode/idle rows in one fused forward per step: the
    port's greedy tokens equal the reference's and the port's own
    sequential serving (chunk boundaries, dt-masked padding, per-row conv
    tails, idle rows)."""
    jcfg, tcfg, jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, 180, size=int(rng.integers(1, 13)))]
               for _ in range(3)]
    max_news = [int(rng.integers(1, 6)) for _ in range(3)]
    kw = dict(chunk=4, max_len=32)
    port = _driver(tm, tp, prompts, max_news, lib="torch", **kw)
    assert port == _driver(jm, jp, prompts, max_news, lib="jax", **kw)
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        assert port[i] == _sequential(tm, tp, p, m, **kw), i


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_matches_dense(arch, impl):
    """Greedy decoding through pages equals dense (the hybrid pages its
    shared-attention KV; the SSM state is not paged and ignores the
    table): the counterpart of ``test_paged_kv.py``'s
    ``test_paged_matches_dense_all_families``."""
    _, tcfg, _, _, _, tp = _pair(arch)
    tcfg = dataclasses.replace(tcfg, attention_impl=impl)
    tm = t_build_model(tcfg)
    rng = np.random.default_rng(13)
    prompt = [int(t) for t in rng.integers(1, tcfg.vocab_size, size=13)]
    max_new, chunk, max_len, page_tokens = 8, 5, 48, 8
    dense = _sequential(tm, tp, prompt, max_new, chunk=chunk, max_len=max_len)

    pool = KVPool(1, max_len, page_tokens, prefix_sharing=False)
    pool.alloc_sequence(0, list(prompt), min(len(prompt) + max_new, max_len))
    caches = tm.init_paged_cache(pool.num_pages, page_tokens, 1, CPU)
    table = torch.from_numpy(pool.table_array())
    logits, caches = tm.prefill_chunked(
        tp, {"tokens": torch.tensor([prompt], dtype=torch.int32)}, max_len, chunk=chunk,
        caches=caches, page_table=table)
    toks = [int(logits[0].argmax())]
    pos = len(prompt)
    while len(toks) < max_new:
        logits, caches = tm.decode_step(
            tp, {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32)}, caches,
            torch.tensor(pos), page_table=table)
        toks.append(int(logits[0].argmax()))
        pos += 1
    assert toks == dense


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_and_distributions(arch):
    """Keys, shapes and dtypes as the reference's (split per layer);
    fixed vectors equal; norms and conv biases zero; every weight matrix at
    the reference's init scale — normal · 1/√d_in, 0.1 for the depthwise
    conv, 0.02 for the embedding — pooled over the layers, within four
    standard errors of a sample std (1/√(2n) relative)."""
    kw = dict(d_model=256, ssm_state=64)
    tcfg = dataclasses.replace(t_get_config(arch).smoke(), **kw)
    jcfg = dataclasses.replace(get_config(arch).smoke(), **kw)
    p = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = params_from_jax(jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(0))),
                         device="cpu")
    tleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), p))
    jleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), jp))
    assert [k for k, _ in tleaves] == [k for k, _ in jleaves]
    pooled = {}
    for (path, t), (_, j) in zip(tleaves, jleaves):
        name = jax.tree_util.keystr(path)
        assert t.shape == j.shape and t.dtype == j.dtype, name
        if name.endswith(("['A_log']", "['D']", "['dt_bias']")):
            np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=name)   # fixed values
        elif j.ndim == 1:
            assert not t.any() and not j.any(), name          # zero norms and conv biases
        else:
            key = "".join(f"[{k.key!r}]" for k in path if hasattr(k, "key"))  # drop the layer
            std = 0.1 if "conv_" in key else 0.02 if key == "['embed']" else t.shape[-2] ** -0.5
            pooled.setdefault(key, (std, []))[1].append(t.astype(np.float32).ravel())
    assert pooled
    for key, (std, parts) in pooled.items():
        v = np.concatenate(parts)
        assert abs(v.std() / std - 1) < 4 / np.sqrt(2 * v.size), key


def test_params_from_jax_splits_the_hybrid_mamba_layers():
    """The reference stacks ``mamba_layers`` even at ``scan_layers=False``;
    the port serves a per-layer list."""
    jcfg = get_config("zamba2-2.7b").smoke()
    assert not jcfg.scan_layers
    jp = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, device="cpu")
    assert isinstance(tp["mamba_layers"], list) and len(tp["mamba_layers"]) == jcfg.n_layers
    for i, layer in enumerate(tp["mamba_layers"]):
        np.testing.assert_array_equal(layer["mamba"]["w_x"].numpy(),
                                      jp["mamba_layers"]["mamba"]["w_x"][i])
        np.testing.assert_array_equal(layer["ln"].numpy(), jp["mamba_layers"]["ln"][i])
    np.testing.assert_array_equal(tp["shared_block"]["attn"]["wq"].numpy(),
                                  jp["shared_block"]["attn"]["wq"])


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_executor_refuse_ssm_and_hybrid(arch):
    """The reference's executor applies attention blocks to every layer
    (it fails with ``KeyError: 'ln_attn'`` at the first step); the port
    refuses at construction and names the model-level entry points."""
    cfg = t_get_config(arch).smoke()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="fused_step"):
        TServingEngine(cfg, params, h100_cluster(1), devices=[CPU], slots=2, max_len=32)
    stage = TStage(device=CPU, layer_ids=list(range(cfg.n_layers)), first=True, last=True)
    with pytest.raises(NotImplementedError, match="model level"):
        TStageExecutor(cfg, params, [stage])

"""Port parity of paged KV with prefix sharing, on the CPU.

The same numpy inputs go through the JAX reference and the port: the pool
scatter and gather (``_paged_update`` / ``_paged_view``), the paged flash
function (the reference's Pallas kernel in interpret mode against the
port's plain version), greedy decoding through pages for every attention
impl, the serving engine with prefix sharing and copy-on-write, the
executor's ``copy_pages`` and the serve CLI.  The port's pool
(``StrictKVPool``) is held to its invariants, to an exact ``can_admit``,
and to the replayed Hypothesis example (seed 656126) on which the
reference's ``KVPool`` admits what it cannot map.

Tolerances: the pool scatter, gather and page copy are exact; the flash
function agrees to atol 1e-5 in fp32 (the same products, summed in another
order); greedy tokens and pool statistics are identical.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import hypothesis, st
from repro.configs import get_config
from repro.core.devices import tpu_slice_cluster
from repro.core.placement import PlanConfig
from repro.kernels.flash_attention import ops as j_ops
from repro.models import layers as j_layers
from repro.models.model import build_model
from repro.serving.engine import Request, ServingEngine
from repro.serving.kv_pool import KVPool as JKVPool
from repro.serving.stage_executor import Stage, StageExecutor
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.devices import h100_cluster
from repro_torch.core.placement import PlanConfig as TPlanConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as t_layers
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serving.engine import Request as TRequest, ServingEngine as TServingEngine
from repro_torch.serving.kv_pool import KVPool, StrictKVPool
from repro_torch.serving.stage_executor import Stage as TStage, StageExecutor as TStageExecutor

CPU = [torch.device("cpu")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(impl):
    """The reference smoke model and its weights carried into the port."""
    jcfg = dataclasses.replace(get_config("llama3.2-1b").smoke(), attention_impl=impl)
    tcfg = dataclasses.replace(t_get_config("llama3.2-1b").smoke(), attention_impl=impl)
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


# ------------------------------------------------------ (a) scatter, gather
def _pool_case(seed, *, np1=7, P=4, kv=2, d=8, b=3, sq=6, pps=3):
    rng = np.random.default_rng(seed)
    pool_k = rng.standard_normal((np1, P, kv, d)).astype(np.float32)
    pool_v = rng.standard_normal((np1, P, kv, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, kv, d)).astype(np.float32)
    # row 0 maps 3 pages, row 1 shares its first page and leaves the last
    # unmapped, row 2 maps one page only
    table = np.asarray([[0, 1, 2], [0, 3, -1], [4, -1, -1]], np.int32)
    # row 0 writes past pages_per_slot·P (pos 9..14 of 12), row 1 writes
    # 2 of 6 tokens at depth 4 (q_len), row 2 writes into unmapped pages
    cache_pos = np.asarray([9, 4, 2], np.int32)
    q_lens = np.asarray([6, 2, 5], np.int32)
    return pool_k, pool_v, table, k, v, cache_pos, q_lens


@pytest.mark.parametrize("with_q_lens", [True, False])
def test_paged_update_matches_reference(with_q_lens):
    pk, pv, table, k, v, cp, ql = _pool_case(0)
    jk, jv = j_layers._paged_update(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(cp), jnp.asarray(ql) if with_q_lens else None,
    )
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    t_layers._paged_update(
        tk, tv, torch.from_numpy(table), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(cp), torch.from_numpy(ql) if with_q_lens else None,
    )
    # every real page exactly as the reference writes it; the trash page
    # (last) takes duplicate writes whose winner neither side fixes
    np.testing.assert_array_equal(tk[:-1].numpy(), np.asarray(jk)[:-1])
    np.testing.assert_array_equal(tv[:-1].numpy(), np.asarray(jv)[:-1])
    assert not np.array_equal(tk[:-1].numpy(), pk[:-1])       # something landed


def test_paged_view_matches_reference():
    pk, _, table, *_ = _pool_case(1)
    ref = j_layers._paged_view(jnp.asarray(pk), jnp.asarray(table))
    out = t_layers._paged_view(torch.from_numpy(pk), torch.from_numpy(table))
    assert tuple(out.shape) == (3, 12, 2, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ------------------------------------------------- (b) the paged flash function
def _flash_case(seed, P, *, b=4, sq=8, h=4, kv=2, d=64, pps=3):
    rng = np.random.default_rng(seed)
    num_pages = 2 * pps + 1
    pool_k = rng.standard_normal((num_pages + 1, P, kv, d)).astype(np.float32)
    pool_v = rng.standard_normal((num_pages + 1, P, kv, d)).astype(np.float32)
    pool_k[-1] = pool_v[-1] = 1e4                 # trash: large finite garbage
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    table = np.full((b, pps), -1, np.int32)
    table[0] = [0, 1, 2]
    table[1, :2] = [0, 3]                         # shares page 0 with row 0
    table[2, :1] = [4]
    table[3] = [5, 1, 6]                          # shares page 1 with row 0
    q_lens = np.asarray([8, 1, 5, 0], np.int32)
    # each row's visible span lies inside its mapped pages
    depth = [pps * P - 8, 2 * P - 1, P - 5, 0]
    return q, pool_k, pool_v, table, np.asarray(depth, np.int32), q_lens


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 30.0)])
@pytest.mark.parametrize("P", [16, 64])
def test_paged_flash_plain_matches_pallas(P, window, softcap):
    q, pk, pv, table, offs, lens = _flash_case(P, P)
    sq = q.shape[1]
    scale = 1.0 / np.sqrt(q.shape[-1])
    q_pos = offs[:, None] + np.arange(sq, dtype=np.int32)[None]
    ref = j_ops.flash_attention_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(q_pos), jnp.asarray(lens), scale=scale, causal=True,
        window=window or None, softcap=softcap or None, interpret=True,
    )
    args = [torch.from_numpy(a) for a in (q, pk, pv, table, offs, lens)]
    kw = dict(scale=scale, causal=True, window=window or None, softcap=softcap or None)
    out = fa.flash_attention_paged_plain(*args, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    for bi, n in enumerate(lens):
        assert not out[bi, n:].any(), f"row {bi} leaked past q_len={n}"
    # the trash page's garbage changes nothing
    args[1] = args[1].clone()
    args[2] = args[2].clone()
    args[1][-1] = args[2][-1] = 0.0
    torch.testing.assert_close(fa.flash_attention_paged_plain(*args, **kw), out, atol=0, rtol=0)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 30.0)])
def test_paged_flash_plain_matches_pallas_head_dim_256(window, softcap):
    """gemma-7b's head dim (256, no GQA) through the page table, pages of
    16 tokens, against the Pallas paged kernel in interpret mode (1e-5)."""
    q, pk, pv, table, offs, lens = _flash_case(256, 16, h=4, kv=4, d=256)
    sq = q.shape[1]
    scale = 1.0 / np.sqrt(256)
    q_pos = offs[:, None] + np.arange(sq, dtype=np.int32)[None]
    ref = j_ops.flash_attention_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(q_pos), jnp.asarray(lens), scale=scale, causal=True,
        window=window or None, softcap=softcap or None, interpret=True,
    )
    args = [torch.from_numpy(a) for a in (q, pk, pv, table, offs, lens)]
    out = fa.flash_attention_paged_plain(*args, scale=scale, causal=True, window=window or None,
                                         softcap=softcap or None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    for bi, n in enumerate(lens):
        assert not out[bi, n:].any(), f"row {bi} leaked past q_len={n}"


def test_paged_flash_wrapper_takes_plain_path_on_cpu():
    q, pk, pv, table, offs, lens = _flash_case(3, 16)
    args = [torch.from_numpy(a) for a in (q, pk, pv, table, offs, lens)]
    before = (fa.launches, fa.paged_launches)
    out = fa.flash_attention_paged(*args, scale=0.125)
    assert torch.equal(out, fa.flash_attention_paged_plain(*args, scale=0.125))
    assert (fa.launches, fa.paged_launches) == before


# --------------------------------------------------- (c) greedy through pages
def _j_greedy(impl, prompt, max_new, chunk, max_len, page_tokens=None):
    """The reference's greedy decode, dense or through pages (as
    ``test_paged_kv.py``'s ``_greedy_dense`` / ``_greedy_paged``)."""
    jcfg, _, jp, _ = _pair(impl)
    m = build_model(jcfg)
    batch = {"tokens": jnp.asarray([prompt], jnp.int32)}
    table, kw = None, {}
    if page_tokens is not None:
        pool = JKVPool(1, max_len, page_tokens, prefix_sharing=False)
        pool.alloc_sequence(0, list(prompt), min(len(prompt) + max_new, max_len))
        kw = dict(caches=m.init_paged_cache(pool.num_pages, page_tokens, 1),
                  page_table=jnp.asarray(pool.table_array()))
        table = kw["page_table"]
    logits, caches = m.prefill_chunked(jp, batch, max_len, chunk=chunk, **kw)
    toks = [int(jnp.argmax(logits[0]))]
    while len(toks) < max_new:
        logits, caches = m.decode_step(
            jp, {"tokens": jnp.asarray([[toks[-1]]], jnp.int32)}, caches,
            jnp.asarray(len(prompt) + len(toks) - 1, jnp.int32), page_table=table,
        )
        toks.append(int(jnp.argmax(logits[0])))
    return toks


def _t_greedy(impl, prompt, max_new, chunk, max_len, page_tokens=None):
    """The port's greedy decode; paged, it passes the raw table (``-1`` for
    unmapped pages) and checks the pool drains clean."""
    _, tcfg, _, tp = _pair(impl)
    m = t_build_model(tcfg)
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32)}
    table, kw, pool = None, {}, None
    if page_tokens is not None:
        pool = StrictKVPool(1, max_len, page_tokens, prefix_sharing=False)
        pool.alloc_sequence(0, list(prompt), min(len(prompt) + max_new, max_len))
        table = torch.from_numpy(pool.table.copy())
        assert (table < 0).any()
        kw = dict(caches=m.init_paged_cache(pool.num_pages, page_tokens, 1, device="cpu"),
                  page_table=table)
    logits, caches = m.prefill_chunked(tp, batch, max_len, chunk=chunk, **kw)
    toks = [int(torch.argmax(logits[0]))]
    while len(toks) < max_new:
        logits, caches = m.decode_step(
            tp, {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32)}, caches,
            torch.tensor(len(prompt) + len(toks) - 1, dtype=torch.int32), page_table=table,
        )
        toks.append(int(torch.argmax(logits[0])))
    if pool is not None:
        pool.free_slot(0)
        pool.check_invariants()
    return toks


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_paged_greedy_matches_reference_and_dense(impl):
    """Chunks of 5 through 8-token pages (every chunk straddles a page
    boundary), as ``test_paged_kv.py::test_paged_matches_dense_fast``."""
    jcfg, *_ = _pair(impl)
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(1, jcfg.vocab_size, size=13)]
    paged = _t_greedy(impl, prompt, 8, 5, 48, page_tokens=8)
    assert paged == _t_greedy(impl, prompt, 8, 5, 48)
    assert paged == _j_greedy(impl, prompt, 8, 5, 48, page_tokens=8)


# ---------------------------------------------------------------- (d) engine
def _shared_prefix_spec(seed=7, n=5, prefix_len=11):
    """Requests 0, 2 and 4 open with one 11-token prefix (as
    ``test_paged_kv.py``)."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(1, 200, size=prefix_len)]
    spec = []
    for i in range(n):
        sfx = [int(t) for t in rng.integers(1, 200, size=int(rng.integers(1, 9)))]
        spec.append((prefix + sfx if i % 2 == 0 else sfx, int(rng.integers(2, 6))))
    return spec


def _t_engine(spec, **plan_kw):
    _, tcfg, _, tp = _pair("pallas")
    eng = TServingEngine(
        tcfg, tp, h100_cluster(1), devices=CPU, slots=3,
        plan_cfg=TPlanConfig(method="etf", **plan_kw), eos_id=-1, max_len=64, prefill_chunk=8,
    )
    reqs = [TRequest(rid=i, prompt=list(p), max_new_tokens=m) for i, (p, m) in enumerate(spec)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and r.state == "finished" for r in reqs)
    return eng, [r.out_tokens for r in reqs]


def test_engine_paged_matches_dense_and_reference_with_prefix_sharing():
    jcfg, _, jp, _ = _pair("chunked")
    spec = _shared_prefix_spec()
    ref = ServingEngine(
        jcfg, jp, tpu_slice_cluster(n_slices=1), slots=3,
        plan_cfg=PlanConfig(method="etf", kv_page_tokens=8), eos_id=-1, max_len=64,
        prefill_chunk=8,
    )
    jreqs = [Request(rid=i, prompt=list(p), max_new_tokens=m) for i, (p, m) in enumerate(spec)]
    for r in jreqs:
        ref.submit(r)
    ref.run_until_drained()

    _, dense = _t_engine(spec)
    eng, paged = _t_engine(spec, kv_page_tokens=8)
    assert paged == dense == [r.out_tokens for r in jreqs]
    pool = eng._kv_pool
    pool.check_invariants()
    stats = pool.stats()
    # request 0 registers the shared prefix; later admissions reuse its
    # full page, copy the partial one and skip their prefill chunks
    assert stats["reused_pages"] >= 1 and stats["cow_copies"] >= 1
    assert eng.prefill_chunks_skipped >= 1
    assert stats == ref._kv_pool.stats()
    assert pool.pages_in_use() == 0
    assert eng.straggler_report()["kv"] == stats

    eng2, private = _t_engine(spec, kv_page_tokens=8, prefix_sharing=False)
    assert private == dense
    assert eng2._kv_pool.stats()["reused_pages"] == 0 and eng2.prefill_chunks_skipped == 0


@pytest.mark.parametrize(
    "bad", [dict(batching="lockstep"), dict(fused=False), dict(prefill_chunk=None)],
    ids=["lockstep", "interleaved", "blocking"],
)
def test_engine_paged_requires_fused_ragged(bad):
    _, tcfg, _, tp = _pair("pallas")
    with pytest.raises(ValueError, match="paged KV"):
        TServingEngine(tcfg, tp, h100_cluster(1), devices=CPU, slots=2,
                       plan_cfg=TPlanConfig(method="etf", kv_page_tokens=8),
                       eos_id=-1, max_len=64, **{"prefill_chunk": 8, **bad})


def test_engine_requeues_a_request_the_pool_cannot_map():
    """An admission whose page mapping fails puts the request back at the
    queue front with its slot freed; it is served later, token-identically
    (the reference loses it from ``active`` instead)."""
    spec = _shared_prefix_spec(seed=3, n=3)
    _, want = _t_engine(spec, kv_page_tokens=8)
    _, tcfg, _, tp = _pair("pallas")
    eng = TServingEngine(tcfg, tp, h100_cluster(1), devices=CPU, slots=3,
                         plan_cfg=TPlanConfig(method="etf", kv_page_tokens=8),
                         eos_id=-1, max_len=64, prefill_chunk=8)
    reqs = [TRequest(rid=i, prompt=list(p), max_new_tokens=m) for i, (p, m) in enumerate(spec)]
    for r in reqs:
        eng.submit(r)
    pool = eng._kv_pool
    real = pool.alloc_sequence
    fails = {"left": 1}

    def alloc_once_failing(slot, tokens, total_len):
        if slot == 1 and fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("page pool exhausted (admission bug)")
        return real(slot, tokens, total_len)

    pool.alloc_sequence = alloc_once_failing
    eng.step()
    assert fails["left"] == 0
    assert eng.active[1] is None and eng.queue[0] is reqs[1] and not reqs[1].started
    eng.run_until_drained()
    assert [r.out_tokens for r in reqs] == want
    pool.check_invariants()
    assert pool.pages_in_use() == 0


# ------------------------------------------------------- (e) executor copies
def test_copy_pages_matches_reference():
    jcfg, tcfg, jp, tp = _pair("pallas")
    n = tcfg.n_layers
    jex = StageExecutor(jcfg, jp, [Stage(device=jax.devices()[0], layer_ids=list(range(n)),
                                         first=True, last=True)])
    tex = TStageExecutor(tcfg, tp, [TStage(device=torch.device("cpu"), layer_ids=list(range(n)),
                                           first=True, last=True)])
    rng = np.random.default_rng(4)
    shape = (6, 4, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    data = [[{key: rng.standard_normal(shape).astype(np.float32) for key in ("k", "v")}
             for _ in range(n)]]
    assert tuple(tex.init_paged_caches(5, 4)[0][0]["k"].shape) == shape
    pairs = [(1, 3), (0, 2), (4, 5)]
    ref = jex.copy_pages(jax.tree.map(jnp.asarray, data), pairs)
    tc = [[{key: torch.from_numpy(a.copy()) for key, a in c.items()} for c in st] for st in data]
    out = tex.copy_pages(tc, pairs)
    assert out is tc
    for li in range(n):
        for key in ("k", "v"):
            np.testing.assert_array_equal(out[0][li][key].numpy(), np.asarray(ref[0][li][key]))


# --------------------------------------------------------------- (f) the CLI
def test_serve_cli_paged_on_cpu(capsys):
    engine, reqs = t_serve.main([
        "--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--requests", "3",
        "--max-new-tokens", "4", "--method", "etf", "--kv-page-tokens", "16",
    ])
    assert engine.kv_page_tokens == 16 and engine.prefix_sharing
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "kv=paged(16,shared)" in out and "[serve] kv pool: {" in out


# ------------------------------------------------------------ (g) the pool
def _random_ops(pool_cls, seed, *, exact=False):
    """The op sequence of ``test_paged_kv.py::test_pool_invariants_random_ops``
    (admit if ``can_admit`` / commit / free, invariants after every op).
    ``exact`` also holds ``can_admit`` to whether a trial allocation on a
    copy of the pool succeeds, before every admission."""
    rng = np.random.default_rng(seed)
    P = int(rng.choice([2, 3, 4]))
    pool = pool_cls(3, 12, P, num_pages=int(rng.integers(6, 14)))
    live = {}
    for _ in range(40):
        op = rng.random()
        free_slots = [s for s in range(3) if s not in live]
        if op < 0.5 and free_slots:
            slot = int(rng.choice(free_slots))
            n = int(rng.integers(1, 11))
            toks = [int(t) for t in rng.integers(1, 5, size=n)]
            total = min(n + int(rng.integers(0, 4)), 12)
            ok = pool.can_admit(toks, total)
            if exact:
                trial = copy.deepcopy(pool)
                try:
                    trial.alloc_sequence(slot, toks, total)
                    mapped = True
                except RuntimeError:
                    mapped = False
                assert ok == mapped, (toks, total)
            if ok:
                pool.alloc_sequence(slot, toks, total)
                live[slot] = toks
        elif op < 0.75 and live:
            slot = int(rng.choice(list(live)))
            pool.commit_prefix(slot, live[slot])
        elif live:
            slot = int(rng.choice(list(live)))
            pool.free_slot(slot)
            del live[slot]
        pool.check_invariants()


def test_verbatim_pool_still_double_counts_seed_656126():
    """The fault StrictKVPool repairs: the verbatim copy of the reference's
    pool admits, at op 33 of seed 656126 (P=2, prompt [1,2,2,2,4,4,4]), a
    sequence whose reused prefix page is the LRU page it counted as free."""
    with pytest.raises(RuntimeError, match="exhausted"):
        _random_ops(KVPool, 656126)


@pytest.mark.parametrize("seed", [656126, 65, 81, 94, 107, 147])
def test_strict_pool_replays_failing_seeds(seed):
    """656126 is the shrunk Hypothesis example; the others are seeds on
    which the verbatim pool also raises."""
    _random_ops(StrictKVPool, seed, exact=True)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(seed=st.integers(0, 10**6))
def test_strict_pool_invariants_random_ops(seed):
    _random_ops(StrictKVPool, seed, exact=True)


def _cow_source_setup(pool_cls):
    """A pool whose free list is empty and whose LRU ring holds two
    registered pages, the COW source the oldest."""
    pool = pool_cls(2, 8, 4, num_pages=3)
    pool.alloc_sequence(0, [1, 2, 3, 4, 5], 8)
    pool.commit_prefix(0, [1, 2, 3, 4, 5])               # registers [1,2,3,4]
    pool.free_slot(0)
    pool.alloc_sequence(1, [9, 9, 9, 9, 7], 8)
    pool.commit_prefix(1, [9, 9, 9, 9, 7])               # registers [9,9,9,9]
    pool.free_slot(1)
    pool.alloc_sequence(1, [5, 5, 5], 4)                 # takes the last free page
    assert pool.free_pages() == 0 and pool.evictable_pages() == 2
    return pool


@pytest.mark.parametrize("pool_cls", [KVPool, StrictKVPool])
def test_cow_never_evicts_its_own_source_while_another_page_is_free(pool_cls):
    """ROADMAP C's unverified case: the COW's ``_take_page`` evicting the
    page ``_match_child`` just picked.  The verbatim pool does (the copy
    pair is an identity and the shared page leaves the registry);
    StrictKVPool evicts the other LRU page and keeps the source shared."""
    pool = _cow_source_setup(pool_cls)
    src = int(next(iter(pool._lru)))                     # the LRU-oldest page
    reuse, copies = pool.alloc_sequence(0, [1, 2, 9], 4)  # diverges in page [1,2,3,4]
    pool.check_invariants()
    assert reuse == 2 and len(copies) == 1 and copies[0][0] == src
    if pool_cls is KVPool:
        assert copies[0][1] == src and pool.lookup_prefix([1, 2, 3, 4, 1]) == 0
    else:
        assert copies[0][1] != src and pool.lookup_prefix([1, 2, 3, 4, 1]) == 4
        assert pool.evictable_pages() == 1 and pool.refcount[src] == 0


def test_cow_adopts_its_source_when_no_other_page_is_obtainable():
    """With the source the only obtainable page, the slot takes the source
    page itself: its rows below the reused length already hold the matched
    prefix, so the copy pair is an identity and nothing is lost."""
    pool = StrictKVPool(2, 8, 4, num_pages=3)
    pool.alloc_sequence(0, [1, 2, 3, 4, 5], 8)
    pool.commit_prefix(0, [1, 2, 3, 4, 5])
    pool.free_slot(0)
    pool.alloc_sequence(1, [5, 5, 5, 5, 5, 5, 5], 8)     # both free pages
    assert pool.free_pages() == 0 and pool.evictable_pages() == 1
    src = int(next(iter(pool._lru)))
    assert pool.can_admit([1, 2, 9], 4)
    reuse, copies = pool.alloc_sequence(0, [1, 2, 9], 4)
    pool.check_invariants()
    assert reuse == 2 and copies == [(src, src)] and pool.table[0, 0] == src
    assert not pool.can_admit([3], 1)

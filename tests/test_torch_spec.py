"""Port parity of speculative draft/target serving, on the CPU, against the
JAX reference.

The reference's smoke weights go into both packages (``params_from_jax``);
a noisy draft is those weights plus numpy noise from a seed, added to the
same leaves of both packages' params.  Held to the reference:

* ``greedy_accept`` and ``rolled_back_draft_pos`` on parametrised cases;
* the flash wrappers on verify rows (``q_len = k+1`` at decode depth)
  mixed with prefill, decode and idle rows, dense and paged, against the
  reference's Pallas kernel in interpret mode (atol 2e-5, fp32);
* ``spec_generate`` — the same tokens and the same ``stats`` as the
  reference's ``spec_generate``, and the tokens of sequential greedy
  decode: self, noisy and wrong drafts, a paged target, several k and
  chunk widths, and the cross-family pairs (a recurrent draft's snapshot,
  a recurrent target's verify-then-commit rewind);
* the engine with a draft — the same tokens as the reference's engine,
  dense and paged, with equal ``speculation_report()`` classes; an MoE
  target; a self draft advancing k+1 tokens a round; the constructor's
  ``ValueError``\\s; the joint draft placement on a heterogeneous cluster.

Tokens and acceptance counts are compared exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.devices import GB, ClusterSpec, DeviceSpec
from repro.core.placement import PlanConfig
from repro.kernels.flash_attention.ops import (
    flash_attention as j_flash,
    flash_attention_paged as j_flash_paged,
)
from repro.models import speculative as j_spec
from repro.models.model import build_model
from repro.serving.engine import Request, ServingEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.devices import (
    ClusterSpec as TClusterSpec,
    DeviceSpec as TDeviceSpec,
    GB as TGB,
)
from repro_torch.core.placement import PlanConfig as TPlanConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import speculative as t_spec
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serving.engine import Request as TRequest, ServingEngine as TServingEngine

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ protocol units
@pytest.mark.parametrize("draft,preds", [
    ([5, 6, 7], [5, 6, 7, 8]),       # full acceptance: the bonus appended
    ([5, 6, 7], [5, 9, 7, 8]),       # the first mismatch truncates
    ([5, 6, 7], [1, 2, 3, 4]),       # zero acceptance still emits one token
    ([4], [4, 2]),                   # k = 1
    ([1, 1, 1, 1, 1], [1, 1, 1, 1, 2, 3]),
])
def test_greedy_accept_matches_reference(draft, preds):
    assert t_spec.greedy_accept(draft, preds) == j_spec.greedy_accept(draft, preds)
    with pytest.raises(AssertionError):
        t_spec.greedy_accept(draft, preds[:-1])


@pytest.mark.parametrize("k", [1, 3, 4, 6])
def test_rolled_back_draft_pos_matches_reference(k):
    for committed in (1, 10, 37):
        for acc in range(k + 1):
            got = t_spec.rolled_back_draft_pos(committed, acc, k)
            assert got == j_spec.rolled_back_draft_pos(committed, acc, k)
            # the next catch-up is the bonus, or d_k and the bonus
            assert committed + acc + 1 - got in (1, 2)


# ------------------------------------------------------- kernel: verify rows
# a verify row IS a q_len > 1 row at decode depth: the pending token + k
# drafts at depth 14 (k = 3), a full prefill chunk, a deep decode row, a
# partial tail chunk and an idle row in one batch (test_spec_decode.py's)
_VERIFY_ROWS = [(14, 4), (0, 8), (19, 1), (5, 3), (0, 0)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged4"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (7, 30.0)])
def test_flash_verify_rows_match_reference_kernel(window, cap, paged):
    """The port's flash wrappers (their plain versions on the CPU) give the
    reference Pallas kernel's output (interpret mode) on verify rows mixed
    with prefill, decode and idle rows, dense and through a page table;
    rows past q_len are exact zeros in both."""
    rng = np.random.default_rng(23)
    b, sq, sk, h, kv, d, P = len(_VERIFY_ROWS), 8, 24, 4, 2, 64, 4
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    cache_pos = np.asarray([r[0] for r in _VERIFY_ROWS], np.int32)
    q_lens = np.asarray([r[1] for r in _VERIFY_ROWS], np.int32)
    q_pos = cache_pos[:, None] + np.arange(sq, dtype=np.int32)[None]
    kw = dict(scale=d ** -0.5, causal=True, window=window or None, softcap=cap or None)
    t = {name: torch.from_numpy(a) for name, a in (("q", q), ("k", k), ("v", v))}
    if paged:
        # each row's keys on its own pages, in a shuffled order; the trash
        # page holds garbage no query may see
        pages = rng.permutation(b * sk // P).reshape(b, sk // P).astype(np.int32)
        pool_k = np.zeros((b * sk // P + 1, P, kv, d), np.float32)
        pool_v = np.zeros_like(pool_k)
        for bi in range(b):
            for j, pg in enumerate(pages[bi]):
                pool_k[pg], pool_v[pg] = k[bi, j * P:(j + 1) * P], v[bi, j * P:(j + 1) * P]
        pool_k[-1], pool_v[-1] = 1e4, -1e4
        ref = j_flash_paged(jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
                            jnp.asarray(pages), jnp.asarray(q_pos), jnp.asarray(q_lens),
                            interpret=True, **kw)
        out = fa.flash_attention_paged(
            t["q"], torch.from_numpy(pool_k), torch.from_numpy(pool_v), torch.from_numpy(pages),
            torch.from_numpy(cache_pos), torch.from_numpy(q_lens), **kw)
    else:
        ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos), None,
                      jnp.asarray(q_lens), interpret=True, **kw)
        out = fa.flash_attention(t["q"], t["k"], t["v"], torch.from_numpy(cache_pos),
                                 torch.from_numpy(q_lens), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    for bi, (_, n) in enumerate(_VERIFY_ROWS):
        assert not out[bi, n:].any() and not np.asarray(ref)[bi, n:].any()


# ------------------------------------------------------------ model level
@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The reference's smoke model of ``arch`` (its default attention) and
    the port's (the kernel wrappers: plain versions on the CPU), with the
    reference's weights in both, as numpy leaves."""
    jcfg = get_config(arch).smoke()
    tcfg = dataclasses.replace(t_get_config(arch).smoke(), attention_impl="pallas")
    jp = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp


def _noisy(np_params, scale, seed=1):
    """``np_params`` plus ``scale · N(0, 1)`` on every float leaf, drawn by
    numpy from ``seed`` in leaf order."""
    if not scale:
        return np_params
    rng = np.random.default_rng(seed)

    def add(leaf):
        if np.issubdtype(leaf.dtype, np.floating):
            return (leaf + scale * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree.map(add, np_params)


def _both(arch, noise=0.0, seed=1):
    """(reference model, its params, port model, its params) of ``arch``,
    with ``noise`` added to the same leaves of both."""
    jcfg, tcfg, jp = _pair(arch)
    p = _noisy(jp, noise, seed)
    return (build_model(jcfg), jax.tree.map(jnp.asarray, p),
            t_build_model(tcfg), params_from_jax(p, device="cpu"))


def _spec_prompts(seed, b=3, lo=1, hi=13):
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(1, 180, size=int(rng.integers(lo, hi)))]
               for _ in range(b)]
    return prompts, [int(rng.integers(2, 9)) for _ in range(b)]


def _sequential(model, params, prompt, max_new, *, chunk, max_len):
    """One request served alone by the port: chunked prefill, then 1-token
    decode."""
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


def _check_spec(target, draft, *, noise=None, noise_seed=1, seed=3, k=3, chunk=4,
                page_tokens=None):
    """The port's ``spec_generate`` against the reference's (tokens and
    stats) and against sequential greedy (tokens); returns the stats."""
    jt, jtp, tt, ttp = _both(target)
    jd, jdp, td, tdp = _both(draft, noise or 0.0, noise_seed)
    prompts, max_news = _spec_prompts(seed)
    kw = dict(spec_tokens=k, chunk=chunk, max_len=64, page_tokens=page_tokens)
    j_stats, t_stats = {}, {}
    ref = j_spec.spec_generate(jt, jtp, jd, jdp, prompts, max_news, stats=j_stats, **kw)
    out = t_spec.spec_generate(tt, ttp, td, tdp, prompts, max_news, stats=t_stats, **kw)
    assert out == ref
    assert t_stats == j_stats
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        assert out[i] == _sequential(tt, ttp, p, m, chunk=chunk, max_len=64), i
    return t_stats


SPEC_CASES = {
    # name: (noise, noise seed, prompt seed, k, chunk, page_tokens)
    "self_k3_c4": (None, 1, 3, 3, 4, None),
    "noisy_k1_c4": (2e-3, 1, 3, 1, 4, None),
    "noisy_k3_c4": (2e-3, 1, 3, 3, 4, None),
    "noisy_k5_c1": (2e-3, 1, 5, 5, 1, None),
    "noisy_k3_c1": (2e-3, 2, 7, 3, 1, None),
    "wrong_k3_c4": (0.5, 1, 9, 3, 4, None),
    "paged8_noisy_k3_c4": (2e-3, 1, 3, 3, 4, 8),
    "paged8_self_k5_c1": (None, 1, 11, 5, 1, 8),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_generate_matches_reference_and_sequential(case):
    noise, nseed, seed, k, chunk, page = SPEC_CASES[case]
    stats = _check_spec("llama3.2-1b", "llama3.2-1b", noise=noise, noise_seed=nseed, seed=seed,
                        k=k, chunk=chunk, page_tokens=page)
    assert stats["rounds"] > 0 and stats["proposed"] == k * stats["rounds"]
    if noise is None:
        assert stats["accepted"] == stats["proposed"]
    else:
        assert stats["accepted"] < stats["proposed"]


@pytest.mark.parametrize("target,draft,page", [
    ("llama3.2-1b", "mamba2-130m", None),     # a recurrent DRAFT: snapshot-restore
    ("mamba2-130m", "llama3.2-1b", None),     # a recurrent TARGET: two-pass commit
    ("zamba2-2.7b", "mamba2-130m", 8),        # hybrid target, paged, SSM draft
])
def test_spec_generate_cross_family(target, draft, page):
    _check_spec(target, draft, seed=5, page_tokens=page)


@pytest.mark.parametrize("noise", [2e-3, 0.5], ids=["noisy", "zero_acceptance"])
def test_recurrent_state_is_restored_in_place(noise):
    """mamba2 as target and draft: the verify forward and the draft's
    proposals overwrite the conv and SSD state in place, so the port must
    put the pre-verify target state and the post-catch-up draft state back
    (without it, the zero-acceptance case — pure rollback — commits
    rejected tokens into the target's state and diverges from greedy, and
    the partial case's draft proposes from a state that saw its rejected
    tokens, changing the acceptance counts)."""
    stats = _check_spec("mamba2-130m", "mamba2-130m", noise=noise, seed=13, k=3)
    if noise == 0.5:
        assert stats["accepted"] == 0 and stats["rounds"] > 0
    else:
        assert 0 < stats["accepted"] < stats["proposed"]


def test_snapshot_and_restore_clone_only_recurrent_state():
    _, _, tm, _ = _both("zamba2-2.7b")
    caches = tm.init_cache(2, 16, CPU)
    state = t_spec.recurrent_state(tm.cfg, caches)
    assert state is caches["mamba"]
    snap = t_spec.snapshot(state)
    assert set(snap) == set(state) and all(snap[k] is not state[k] for k in snap)
    before = {k: v.data_ptr() for k, v in state.items()}
    for v in state.values():
        v.add_(1.0)
    t_spec.restore(state, snap)
    assert all(torch.equal(state[k], snap[k]) for k in snap)
    assert {k: v.data_ptr() for k, v in state.items()} == before     # in place
    _, _, lm, _ = _both("llama3.2-1b")
    assert t_spec.recurrent_state(lm.cfg, lm.init_cache(2, 16, CPU)) is None


# ------------------------------------------------------------ engine level
def _clusters():
    """The reference test's 2-strong / 2-weak cluster, in both packages."""
    out = []
    for cls, dev, gb in ((ClusterSpec, DeviceSpec, GB), (TClusterSpec, TDeviceSpec, TGB)):
        out.append(cls(
            devices=[
                dev("strong0", peak_flops=100e12, mem_bytes=40 * gb, hbm_bw=1500e9),
                dev("strong1", peak_flops=100e12, mem_bytes=40 * gb, hbm_bw=1500e9),
                dev("weak0", peak_flops=8e12, mem_bytes=16 * gb, hbm_bw=250e9),
                dev("weak1", peak_flops=8e12, mem_bytes=16 * gb, hbm_bw=250e9),
            ],
            link_bw=np.full((4, 4), 50e9) * (1 - np.eye(4)),
            name="spec-hetero",
        ))
    return out


def _engine_requests(cls, seed=7, n=6):
    rng = np.random.default_rng(seed)
    return [
        cls(rid=i, prompt=[int(t) for t in rng.integers(1, 180, size=int(rng.integers(1, 13)))],
            max_new_tokens=int(rng.integers(3, 9)), tier=i % 2)
        for i in range(n)
    ]


def _engines(arch, *, draft=None, noise=None, spec_tokens=0, page_tokens=None, seed=7):
    """The reference's and the port's engine on the same weights and
    requests, each served to the end; ``draft`` attaches that arch's model
    (plus ``noise``) as the draft."""
    jc, tc = _clusters()
    jm, jp, tm, tp = _both(arch)
    kw = dict(slots=3, max_len=64, eos_id=-1)
    pc = dict(method="etf", objective="throughput", serving_slots=3, prefill_chunk=4,
              spec_tokens=spec_tokens, kv_page_tokens=page_tokens)
    jkw, tkw = {}, {}
    if draft is not None:
        jd, jdp, td, tdp = _both(draft, noise or 0.0)
        jkw = dict(draft_cfg=jd.cfg, draft_params=jdp)
        tkw = dict(draft_cfg=td.cfg, draft_params=tdp)
    ref = ServingEngine(jm.cfg, jp, jc, plan_cfg=PlanConfig(**pc), **kw, **jkw)
    eng = TServingEngine(tm.cfg, tp, tc, devices=[CPU], plan_cfg=TPlanConfig(**pc), **kw, **tkw)
    for e, cls in ((ref, Request), (eng, TRequest)):
        for r in _engine_requests(cls, seed=seed):
            e.submit(r)
        e.run_until_drained()
    return ref, eng


def _tokens(eng):
    return {r.rid: list(r.out_tokens) for r in eng.finished}


@pytest.mark.parametrize("page_tokens", [None, 8], ids=["dense", "paged8"])
def test_engine_spec_matches_reference(page_tokens):
    """A noisy draft attached: the port's engine gives the reference
    engine's tokens (which are the plain engine's) and the same acceptance
    counts per request class; the joint draft placement is the
    reference's."""
    ref, eng = _engines("llama3.2-1b", draft="llama3.2-1b", noise=2e-3, spec_tokens=3,
                        page_tokens=page_tokens)
    assert _tokens(eng) == _tokens(ref) and len(_tokens(eng)) == 6
    assert eng._draft_placement == ref._draft_placement
    assert eng.placement_result.placement == ref.placement_result.placement
    rep, jrep = eng.straggler_report()["speculation"], ref.straggler_report()["speculation"]
    assert rep == jrep
    assert set(rep["classes"]) == {"tier0", "tier1"}
    for row in rep["classes"].values():
        assert row["rounds"] > 0 and 1.0 <= row["tokens_per_round"] <= 4.0
    _, plain = _engines("llama3.2-1b", page_tokens=page_tokens)
    assert _tokens(plain) == _tokens(eng)
    assert plain.straggler_report()["speculation"] is None
    if page_tokens:
        assert eng._kv_pool.pages_in_use() == 0
        assert eng._kv_pool.stats() == ref._kv_pool.stats()


def test_engine_spec_moe_target_with_dense_draft():
    """qwen2-moe's smoke target (the grouped GEMM's plain version) with the
    llama smoke model drafting: the reference's tokens and counts."""
    ref, eng = _engines("qwen2-moe-a2.7b", draft="llama3.2-1b", spec_tokens=2, seed=5)
    assert _tokens(eng) == _tokens(ref) and len(_tokens(eng)) == 6
    assert eng.speculation_report() == ref.speculation_report()
    assert eng._draft_executor.cfg.family == "dense" and eng.executor.cfg.family == "moe"


def test_engine_spec_self_draft_multi_advance():
    """Draft == target: every round accepts all k proposals, so slots
    advance k+1 tokens a fused step — fewer steps than tokens — and the
    tokens are still the plain engine's."""
    _, plain = _engines("llama3.2-1b", seed=11)
    ref, eng = _engines("llama3.2-1b", draft="llama3.2-1b", spec_tokens=3, seed=11)
    assert _tokens(eng) == _tokens(plain) == _tokens(ref)
    for row in eng.speculation_report()["classes"].values():
        assert row["acceptance_rate"] == 1.0 and row["tokens_per_round"] == 4.0
    tc = _clusters()[1]
    _, _, tm, tp = _both("llama3.2-1b")
    eng = TServingEngine(tm.cfg, tp, tc, devices=[CPU], slots=3, max_len=64, eos_id=-1,
                         plan_cfg=TPlanConfig(method="etf", prefill_chunk=4, spec_tokens=3),
                         draft_cfg=tm.cfg, draft_params=tp)
    reqs = _engine_requests(TRequest, seed=11)
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.step():
        steps += 1
    assert all(r.done for r in reqs)
    assert steps < sum(len(r.out_tokens) for r in reqs) / 2


def test_engine_spec_defaults_k_to_four():
    tc = _clusters()[1]
    _, _, tm, tp = _both("llama3.2-1b")
    eng = TServingEngine(tm.cfg, tp, tc, devices=[CPU], slots=2, max_len=64,
                         plan_cfg=TPlanConfig(method="etf"), draft_cfg=tm.cfg, draft_params=tp)
    assert eng.spec_tokens == 4 and eng.plan_cfg.spec_tokens == 4
    assert eng.speculation_report()["planned_tokens_per_round"] == pytest.approx(
        (1 - 0.75 ** 5) / 0.25)


def test_engine_spec_refusals():
    tc = _clusters()[1]
    _, _, tm, tp = _both("llama3.2-1b")
    kw = dict(devices=[CPU], slots=2, max_len=64,
              plan_cfg=TPlanConfig(method="etf", spec_tokens=3))
    with pytest.raises(ValueError, match="fused"):
        TServingEngine(tm.cfg, tp, tc, fused=False, draft_cfg=tm.cfg, draft_params=tp, **kw)
    with pytest.raises(ValueError, match="draft_params"):
        TServingEngine(tm.cfg, tp, tc, draft_cfg=tm.cfg, **kw)
    # the stage executor serves attention-family blocks only: an SSM draft
    # fails at construction, as in the reference
    _, _, sm, sp = _both("mamba2-130m")
    with pytest.raises(ValueError, match="dense/moe draft"):
        TServingEngine(tm.cfg, tp, tc, draft_cfg=sm.cfg, draft_params=sp, **kw)
    plain = TServingEngine(tm.cfg, tp, tc, **kw)
    with pytest.raises(ValueError, match="placement_result"):
        TServingEngine(tm.cfg, tp, tc, draft_cfg=tm.cfg, draft_params=tp,
                       placement_result=plain.placement_result, **kw)


def test_engine_spec_rebuild_drops_the_draft_caches():
    """A device failure re-plans the merged problem, rebuilds the draft
    executor and drops its caches; the re-queued requests still finish with
    the plain engine's tokens."""
    _, plain = _engines("llama3.2-1b", seed=17)
    tc = _clusters()[1]
    _, _, tm, tp = _both("llama3.2-1b")
    _, _, td, tdp = _both("llama3.2-1b", 2e-3)
    eng = TServingEngine(tm.cfg, tp, tc, devices=[CPU], slots=3, max_len=64, eos_id=-1,
                         plan_cfg=TPlanConfig(method="etf", objective="throughput",
                                              serving_slots=3, prefill_chunk=4, spec_tokens=3),
                         draft_cfg=td.cfg, draft_params=tdp)
    reqs = _engine_requests(TRequest, seed=17)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    old = eng._draft_executor
    assert eng._draft_caches is not None
    dead = sorted(set(eng._draft_placement.values()) | set(eng.placement_result.placement.values()))[0]
    eng.on_device_failure(dead)
    assert eng._draft_executor is not old and eng._draft_caches is None
    assert not eng._draft_pos.any()
    assert dead not in set(eng._draft_placement.values())
    eng.run_until_drained()
    assert {r.rid: r.out_tokens for r in reqs} == _tokens(plain)

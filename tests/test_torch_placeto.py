"""The port's placeto baseline against the JAX reference.

``jax.random`` is not reproduced, so the two packages are held on the same
sampled choices: each package's sampler is replaced by one that returns a
fixed, numpy-seeded sequence of choices and records the policy logits it
was given.  The first batch meets the zero policy; every later batch's
logits are ``feats @ w`` after the packages' own rewards, baselines and
``grad_step``s, so equal logits mean equal rewards and equal steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.placeto as j_placeto
import repro_torch.core.placeto as t_placeto
from repro.core.costmodel import CostModel
from repro.core.devices import inter_server_cluster
from repro.core.graph import random_dag
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.costmodel import CostModel as TCostModel
from repro_torch.core.devices import h100_cluster, inter_server_cluster as t_inter_server_cluster
from repro_torch.core.graph import random_dag as t_random_dag
from repro_torch.core.modelgraph import transformer_graph as t_transformer_graph
from repro_torch.core.placement import PlanConfig as TPlanConfig, plan as t_plan
from repro_torch.core.simulate import bottleneck_time, simulate

CPU = torch.device("cpu")


def _fixed_choices(n, k, count, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, k, size=n) for _ in range(count)]


@pytest.mark.parametrize("objective", ["latency", "throughput"])
def test_fixed_choices_give_the_reference_rewards_and_steps(monkeypatch, objective):
    iters, batch = 4, 3
    jg, tg = random_dag(12, seed=2), t_random_dag(12, seed=2)
    jcm, tcm = CostModel(inter_server_cluster()), TCostModel(t_inter_server_cluster())
    choices = _fixed_choices(len(jg.nodes), jcm.cluster.k, iters * batch)

    j_logits, t_logits = [], []
    j_it, t_it = iter(choices), iter(choices)

    def j_categorical(key, logits, axis=-1):
        j_logits.append(np.asarray(logits))
        return jnp.asarray(next(j_it), jnp.int32)

    def t_sample(logits, generator):
        t_logits.append(logits.numpy().copy())
        return next(t_it).copy()

    # the reference's sampler and step run eagerly so the fake sampler
    # sees concrete logits
    monkeypatch.setattr(jax, "jit", lambda f: f)
    monkeypatch.setattr(jax.random, "categorical", j_categorical)
    monkeypatch.setattr(t_placeto, "_sample", t_sample)
    kw = dict(iters=iters, batch=batch, seed=0, objective=objective)
    ref = j_placeto.placeto(jg, jcm, **kw)
    got = t_placeto.placeto(tg, tcm, device=CPU, **kw)

    assert len(t_logits) == len(j_logits) == iters * batch
    assert not np.any(t_logits[0]) and np.any(t_logits[-1])
    for t, j in zip(t_logits, j_logits):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    assert got.placement == ref.placement
    assert got.objective == pytest.approx(ref.objective, rel=1e-12)
    assert (got.status, got.method, got.extra) == (ref.status, ref.method, ref.extra)


def test_features_and_grad_step_match_reference():
    jg, tg = random_dag(15, seed=7), t_random_dag(15, seed=7)
    feats = j_placeto._features(jg)
    np.testing.assert_array_equal(t_placeto._features(tg), feats)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((feats.shape[1], 4)).astype(np.float32)
    adv = rng.standard_normal(5).astype(np.float32)
    ch = rng.integers(0, 4, size=(5, feats.shape[0]))

    def loss(w):
        logp = jax.nn.log_softmax(jnp.asarray(feats) @ w, axis=-1)
        return -(adv * logp[jnp.arange(feats.shape[0])[None, :], ch].sum(-1)).mean()

    want = w - 0.05 * np.asarray(jax.grad(loss)(jnp.asarray(w)))
    got = t_placeto.grad_step(torch.from_numpy(w), torch.from_numpy(feats),
                              torch.from_numpy(adv), torch.from_numpy(ch), 0.05)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_placeto_improves_over_random():
    """The RL baseline must at least learn to beat its own random init."""
    g = t_random_dag(20, seed=5)
    cm = TCostModel(t_inter_server_cluster())
    rng = np.random.default_rng(0)
    random_mks = [
        simulate(g, {n: int(rng.integers(0, 4)) for n in g.nodes}, cm).makespan
        for _ in range(8)
    ]
    res = t_placeto.placeto(g, cm, iters=40, batch=6, seed=1, device=CPU)
    mk = simulate(g, res.placement, cm).makespan
    assert mk <= np.mean(random_mks)


def test_placeto_reward_threads_throughput_objective():
    g = t_random_dag(16, seed=5)
    cm = TCostModel(h100_cluster(4, heterogeneous=True))
    res = t_placeto.placeto(g, cm, iters=25, batch=4, seed=1, objective="throughput", device=CPU)
    assert res.extra["objective"] == "throughput"
    # the trained agent beats the mean random placement at ITS OWN objective
    rng = np.random.default_rng(0)
    random_b = [
        bottleneck_time(g, {n: int(rng.integers(0, 4)) for n in g.nodes}, cm)
        for _ in range(8)
    ]
    assert bottleneck_time(g, res.placement, cm) <= np.mean(random_b)
    with pytest.raises(ValueError):
        t_placeto.placeto(g, cm, iters=1, objective="goodput", device=CPU)


def test_plan_placeto_on_h100_cluster():
    tg = t_transformer_graph(t_get_config("llama3.2-1b").smoke(), seq_len=64, granularity="block")
    res = t_plan(tg, h100_cluster(2), TPlanConfig(method="placeto", placeto_iters=20,
                                                  placeto_device="cpu"))
    assert set(res.placement) == set(tg.nodes)
    assert set(res.placement.values()) <= {0, 1}
    assert res.method == "placeto-rl" and np.isfinite(res.objective)
    # the same seed gives the same plan
    again = t_plan(tg, h100_cluster(2), TPlanConfig(method="placeto", placeto_iters=20,
                                                    placeto_device="cpu"))
    assert again.placement == res.placement

"""The generator: reproducible from the seed, the same sizes for every
seed, open-loop gaps and shared-prefix popularity as the mix states."""

from collections import Counter

import numpy as np

from portbench.tests._tiny import load
from portbench.harness import traffic


def _sizes(tr):
    return sorted(len(p.prompt) for p in tr.planned), sorted(p.max_new for p in tr.planned)


def test_same_seed_same_requests():
    mix = load("mixes", "chat")
    a = traffic.generate(mix, 2**31 + 7, 151936, 256)
    b = traffic.generate(mix, 2**31 + 7, 151936, 256)
    assert [(p.prompt, p.max_new) for p in a.planned] == [(p.prompt, p.max_new) for p in b.planned]
    c = traffic.generate(mix, 2**31 + 8, 151936, 256)
    assert [p.prompt for p in a.planned] != [p.prompt for p in c.planned]


def test_every_seed_gets_the_same_sizes_per_block():
    mix = dict(load("mixes", "chat"), first_wave_residual=False)
    n = 4 * traffic.BLOCK
    a = traffic.generate(mix, 1, 1000, n)
    b = traffic.generate(mix, 99, 1000, n)
    assert _sizes(a) == _sizes(b)
    # each whole block holds the block's multiset
    for k in range(4):
        blk = a.planned[k * traffic.BLOCK:(k + 1) * traffic.BLOCK]
        assert sorted(len(p.prompt) for p in blk) == sorted(traffic.quantiles(mix["prompt"], traffic.BLOCK))
    lens = [len(p.prompt) for p in a.planned]
    assert min(lens) >= 128 and max(lens) <= 2048
    assert 400 <= np.median(lens) <= 640


def test_first_wave_residual_cuts_only_the_first_clients():
    mix = load("mixes", "chat")
    full = traffic.generate(dict(mix, first_wave_residual=False), 5, 1000, 128)
    cut = traffic.generate(mix, 5, 1000, 128)
    k = mix["clients"]
    assert sum(len(p.prompt) for p in cut.planned[:k]) < sum(len(p.prompt) for p in full.planned[:k])
    assert all(p.max_new >= 1 for p in cut.planned)
    assert [p.max_new for p in cut.planned[k:]] == [p.max_new for p in full.planned[k:]]


def test_open_loop_offsets_and_zipf_prefixes():
    mix = load("mixes", "sysprompt-open")
    tr = traffic.generate(mix, 3, 151936, 2 * traffic.BLOCK)
    offs = [p.offset_s for p in tr.planned]
    assert all(b > a for a, b in zip(offs, offs[1:]))
    # a whole block's gaps sum to the same time for every seed
    tr2 = traffic.generate(mix, 4, 151936, 2 * traffic.BLOCK)
    assert abs(offs[traffic.BLOCK - 1] - tr2.planned[traffic.BLOCK - 1].offset_s) < 1e-9
    assert abs(offs[-1] / len(offs) - 1 / mix["rate_per_s"]) < 0.05 / mix["rate_per_s"]
    counts = Counter(p.prefix for p in tr.planned[: traffic.BLOCK])
    assert [counts[k] for k in range(4)] == traffic.zipf_counts(4, 1.0, traffic.BLOCK).tolist()
    assert traffic.zipf_counts(4, 1.0, 64).tolist() == [31, 15, 10, 8]
    sp = mix["shared_prefix"]["tokens"]
    for p in tr.planned:
        assert p.prompt[:sp] == tr.prefixes[p.prefix]
        assert 64 <= len(p.prompt) - sp <= 512 and 16 <= p.max_new <= 64


def test_requests_needed_covers_the_run():
    mix = load("mixes", "sysprompt-open")
    n = traffic.requests_needed(mix, 30)
    assert n % traffic.BLOCK == 0 and n >= mix["rate_per_s"] * (30 + mix["warmup_s"]) * 1.5

"""The one traffic generator: reads a mix file's parameters and makes the
requests of a run from ``--seed``.

Every seed gets the same multiset of sizes and gaps, in another order:
each length (and each open-loop gap) is drawn by stratified quantiles in
blocks of ``block`` requests, so every whole block holds the same values,
shuffled by the seed.  Token ids, the order within blocks and the choice
of shared prefix (by fixed counts per block) come from the seed.

Mix keys read here:

* ``loop``: ``"closed"`` (``clients`` callers, each sending its next
  request when the last one finished) or ``"open"`` (arrivals at
  ``rate_per_s``, exponential gaps).
* ``prompt`` and ``output``: ``{"dist": "lognormal", "median", "sigma",
  "min", "max"}`` or ``{"dist": "uniform", "min", "max"}`` (integers,
  both ends included).  With ``shared_prefix`` the prompt is the user turn
  after the prefix.
* ``shared_prefix``: ``{"count", "tokens", "zipf_s"}``: ``count`` prefixes
  of ``tokens`` tokens, prefix k chosen with weight ``1/(k+1)^zipf_s``.
* ``first_wave_residual`` (closed loop): the first request of each client
  keeps a stratified share ``u`` of its drawn prompt and output, as a
  client caught mid-request would, so the clients do not start in step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import List, Optional

import numpy as np

BLOCK = 64


@dataclass
class Planned:
    """One request of the traffic, before it is sent."""

    index: int
    prompt: List[int]
    max_new: int
    offset_s: Optional[float] = None   # open loop: due this long after the traffic starts
    prefix: int = -1                   # shared prefix index, -1 for none


def quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` integer values of the distribution ``spec`` at the stratified
    levels ``(i + 0.5) / n``, clipped to ``[min, max]``."""
    u = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        vals = spec["median"] * np.exp(spec["sigma"] * z)
    elif dist == "uniform":
        vals = spec["min"] + np.floor(u * (spec["max"] - spec["min"] + 1))
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def exp_gaps(mean: float, n: int) -> np.ndarray:
    """``n`` exponential gaps of mean ``mean`` at the stratified levels."""
    u = (np.arange(n) + 0.5) / n
    return -mean * np.log1p(-u)


def stratified(values_of_block: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` values: the block's multiset, shuffled anew in every block."""
    blocks = -(-n // len(values_of_block))
    return np.concatenate([rng.permutation(values_of_block) for _ in range(blocks)])[:n]


def zipf_counts(count: int, s: float, n: int) -> np.ndarray:
    """How many of ``n`` requests take each of ``count`` prefixes under
    weights ``1/(k+1)^s``, by largest remainder."""
    w = np.array([1.0 / (k + 1) ** s for k in range(count)])
    share = w / w.sum() * n
    out = np.floor(share).astype(np.int64)
    for k in np.argsort(-(share - out))[: n - out.sum()]:
        out[k] += 1
    return out


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's draws (any size of seed)."""
    return np.random.default_rng([int(seed) & (2**63 - 1), stream])


@dataclass
class Traffic:
    """The requests of one run, in the order they are sent."""

    mix: dict
    planned: List[Planned]
    prefixes: List[List[int]] = field(default_factory=list)


def generate(mix: dict, seed: int, vocab: int, n: int) -> Traffic:
    """``n`` requests of ``mix`` from ``seed``, token ids in
    ``[1, vocab)``."""
    rng = seed_rng(seed, 1)
    prompt_lens = stratified(quantiles(mix["prompt"], BLOCK), n, rng)
    out_lens = stratified(quantiles(mix["output"], BLOCK), n, rng)
    sp = mix.get("shared_prefix")
    prefixes: List[List[int]] = []
    which = np.full(n, -1)
    if sp:
        per_block = zipf_counts(sp["count"], sp.get("zipf_s", 1.0), BLOCK)
        which = stratified(np.repeat(np.arange(sp["count"]), per_block), n, rng)
        prefixes = [rng.integers(1, vocab, size=sp["tokens"]).tolist() for _ in range(sp["count"])]
    if mix["loop"] == "closed" and mix.get("first_wave_residual"):
        k = min(mix["clients"], n)
        u = (np.arange(k) + 0.5) / k
        prompt_lens[:k] = np.maximum(1, np.rint(rng.permutation(u) * prompt_lens[:k]))
        out_lens[:k] = np.maximum(1, np.rint(rng.permutation(u) * out_lens[:k]))
    offsets = None
    if mix["loop"] == "open":
        offsets = np.cumsum(stratified(exp_gaps(1.0 / mix["rate_per_s"], BLOCK), n, rng))
    elif mix["loop"] != "closed":
        raise ValueError(f"loop must be closed or open, got {mix['loop']!r}")
    tokens = rng.integers(1, vocab, size=int(prompt_lens.sum()))
    planned, at = [], 0
    for i in range(n):
        body = tokens[at : at + prompt_lens[i]].tolist()
        at += prompt_lens[i]
        prompt = (prefixes[which[i]] + body) if which[i] >= 0 else body
        planned.append(Planned(
            index=i, prompt=prompt, max_new=int(out_lens[i]),
            offset_s=None if offsets is None else float(offsets[i]), prefix=int(which[i]),
        ))
    return Traffic(mix=mix, planned=planned, prefixes=prefixes)


def requests_needed(mix: dict, seconds: float) -> int:
    """How many requests a run of ``seconds`` (after the mix's warm-up)
    can send at most, with room: open loop by the rate, closed loop by the
    mix's ``max_requests_per_s`` bound."""
    span = seconds + mix.get("warmup_s", 0.0)
    if mix["loop"] == "open":
        n = mix["rate_per_s"] * span * 1.5 + 2 * BLOCK
    else:
        n = mix["clients"] + mix["max_requests_per_s"] * (span + 60.0)
    return int(math.ceil(n / BLOCK) * BLOCK)

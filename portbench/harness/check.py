"""Whether the timed path served the right tokens.

Once the window has closed, a sample of the requests the engine finished,
drawn from the seed and holding the longest, goes through the plain
reference once each, over its prompt and the tokens the engine served.
At each served token's position the reference's float32 logits give the
gap by which the served token lies below the reference's best; a greedy
engine that computes what the reference computes serves gaps of rounding
size only.  The number compared is the widest gap of the sample.

Requests that share a prefix of the mix's ``shared_prefix`` tokens share
one reference pass over it.  The control (the reference in fp8, in the
program's place) is read at the same positions: the gap of the token it
puts first.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.reference import family
from portbench.reference.common import Precision

from .traffic import seed_rng


def sample(recs, seed: int, served_tokens: int) -> list:
    """Finished requests drawn from ``seed``: the one with the most served
    tokens, then others in a random order until the sample holds
    ``served_tokens`` served tokens."""
    done = [r for r in recs if r.req.done and r.req.state == "finished" and r.req.out_tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.req.out_tokens), -r.planned.index))
    pick, total = [longest], len(longest.req.out_tokens)
    for i in seed_rng(seed, 2).permutation(len(done)):
        if total >= served_tokens:
            break
        if done[i] is longest:
            continue
        pick.append(done[i])
        total += len(done[i].req.out_tokens)
    return pick


def short_answers(recs) -> int:
    """Finished requests served fewer or more tokens than they asked for
    (the engine runs with no end-of-sequence token)."""
    return sum(1 for r in recs if r.req.done and r.req.state == "finished"
               and len(r.req.out_tokens) != r.planned.max_new)


def compare(cfg: dict, weights: dict, samples: Sequence[Tuple[List[int], List[int]]],
            device, prefix_tokens: int = 0, control: bool = False) -> Dict[str, float]:
    """Gaps of the served tokens of ``samples`` (``(prompt, served)``)
    under the reference; with ``control``, the fp8 reference's gaps too.
    Returns ``max_gap``, ``mean_gap``, ``mismatch_share`` (served token not
    the reference's best), ``tokens``, and ``control_*`` alike."""
    ref = family(cfg["model_type"])
    precs = [Precision("fp32")] + ([Precision("fp8")] if control else [])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    groups: Dict[Optional[tuple], List[int]] = {}
    for i, (prompt, _) in enumerate(samples):
        key = (tuple(prompt[:prefix_tokens])
               if prefix_tokens and len(prompt) > prefix_tokens else None)
        groups.setdefault(key, []).append(i)
    gaps, cgaps = [], []
    try:
        with torch.inference_mode():
            for key, idxs in groups.items():
                pasts = [None] * len(precs)
                if key is not None:
                    toks = torch.tensor(key, dtype=torch.int64, device=device)
                    none = torch.zeros(0, dtype=torch.int64, device=device)
                    for j, p in enumerate(precs):
                        pasts[j] = ref.forward(weights, cfg, toks, none, p)[1]
                for i in idxs:
                    prompt, served = samples[i]
                    start = len(key) if key is not None else 0
                    seq = (list(prompt) + list(served[:-1]))[start:]
                    toks = torch.tensor(seq, dtype=torch.int64, device=device)
                    rows = torch.arange(len(served), device=device) + (len(prompt) - 1 - start)
                    at = torch.arange(len(served), device=device)
                    logits = ref.forward(weights, cfg, toks, rows, precs[0], pasts[0])[0]
                    best = logits.max(-1).values
                    got = torch.tensor(served, dtype=torch.int64, device=device)
                    gaps.append((best - logits[at, got]).cpu())
                    if control:
                        clog = ref.forward(weights, cfg, toks, rows, precs[1], pasts[1])[0]
                        cgaps.append((best - logits[at, clog.argmax(-1)]).cpu())
                        del clog
                    del logits
                del pasts
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = _summary(gaps, "")
    if control:
        out.update(_summary(cgaps, "control_"))
    return out


def _summary(gaps: List[torch.Tensor], prefix: str) -> Dict[str, float]:
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    if not g.numel():
        return {prefix + "tokens": 0}
    return {
        prefix + "max_gap": float(g.max()),
        prefix + "mean_gap": float(g.mean()),
        prefix + "mismatch_share": float((g > 0).float().mean()),
        prefix + "tokens": int(g.numel()),
    }

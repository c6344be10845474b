"""Greedy speculative decoding: a draft model proposes, the target verifies.

The variable-advance step contract: a row may submit ``k`` draft tokens
plus the pending token in ONE ragged target forward (``q_len=k+1``, riding
the per-row ``(cache_pos, q_len)`` of the fused step), and advance by a
*variable* ``accepted + 1`` tokens — the longest prefix of the draft that
matches the target's own greedy predictions, plus the target's "bonus"
token after it.  By construction the emitted stream is token-identical to
plain greedy decode: every emitted token IS a target argmax conditioned on
previously emitted tokens.

Rollback is bookkeeping, not data movement, for attention KV; the caches
of the port are written in place, so recurrent state needs a snapshot:

* **Attention KV** — rejected tokens leave garbage K/V at positions
  ``[pos+accepted+1, pos+k+1)``, but a row only ever *attends* positions it
  has fed (``< cache_pos`` of the live query), and every fed position is
  rewritten by the feed itself, so garbage is always overwritten before it
  can be read.  Dense and paged layouts share this argument (paged writes
  land in the slot's private pages; callers keep ``cache_pos + k + 1 <=
  total_head`` so the trash page is never attended).  It holds for writes
  in place as it does for fresh arrays: no KV is cloned.
* **SSM / hybrid state** — the mamba2 recurrence is not invertible, and
  the forward overwrites the conv tails and the SSD state in place.  A
  recurrent TARGET's conv and SSD state is cloned before the verify
  forward and copied back after it; a *commit* pass then re-runs only the
  accepted tokens: the dt-masking that freezes state at each row's
  ``q_len`` boundary makes the commit land exactly at the accepted
  boundary.  A recurrent DRAFT's state is cloned after its catch-up
  forward and copied back after the verify, so the next catch-up re-feeds
  the accepted span from there.  Only the recurrent tensors are cloned
  (KB to MB a model), never the KV.  Attention-only families skip both.

``spec_generate`` is the model-level loop (every family, paged or dense
target KV) that the tests pin against sequential greedy decode; the
serving engine implements the same protocol against its ``StageExecutor``
stack and shares ``greedy_accept`` / ``rolled_back_draft_pos`` so the two
can never drift.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def greedy_accept(
    draft_tokens: Sequence[int], target_preds: Sequence[int]
) -> Tuple[int, List[int]]:
    """Longest-prefix greedy acceptance.

    Args:
        draft_tokens: the ``k`` proposed tokens ``d_1..d_k``.
        target_preds: ``k+1`` target argmax tokens from the verify forward —
            ``target_preds[i]`` is the target's greedy token after consuming
            the pending token plus ``d_1..d_i``.

    Returns:
        ``(accepted, emitted)`` where ``accepted`` is the number of draft
        tokens kept and ``emitted = d_1..d_accepted + [bonus]`` — the bonus
        being the target's own prediction after the accepted prefix, so one
        token is always emitted even at zero acceptance.
    """
    assert len(target_preds) == len(draft_tokens) + 1
    j = 0
    while j < len(draft_tokens) and int(draft_tokens[j]) == int(target_preds[j]):
        j += 1
    return j, [int(t) for t in draft_tokens[:j]] + [int(target_preds[j])]


def rolled_back_draft_pos(committed_len: int, accepted: int, spec_tokens: int) -> int:
    """Valid draft-cache depth after a verify (attention-family drafts).

    The draft consumed the committed sequence (``committed_len`` tokens)
    plus its own first ``k-1`` proposals; of those, exactly the accepted
    ones remain valid.  The next catch-up feed is therefore 1 token (the
    bonus) on a partial accept and 2 (``d_k`` + bonus) on a full accept —
    recurrent drafts instead restore the post-catch-up snapshot and re-feed
    the whole accepted span.
    """
    return committed_len + min(accepted, spec_tokens - 1)


def recurrent_state(cfg, caches) -> Optional[Dict[str, torch.Tensor]]:
    """The tensors of ``caches`` a forward overwrites irreversibly: the
    Mamba layers' conv tails and SSD state (the SSM family's whole cache,
    the hybrid's ``"mamba"`` part); None for attention-only families."""
    if cfg.family == "ssm":
        return caches["layers"]
    if cfg.family == "hybrid":
        return caches["mamba"]
    return None


def snapshot(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of the recurrent tensors (:func:`recurrent_state`)."""
    return {k: v.clone() for k, v in state.items()}


def restore(state: Dict[str, torch.Tensor], snap: Dict[str, torch.Tensor]) -> None:
    """Write a :func:`snapshot` back into the live tensors, in place."""
    for k, v in snap.items():
        state[k].copy_(v)


def spec_generate(
    target,
    target_params,
    draft,
    draft_params,
    prompts: Sequence[Sequence[int]],
    max_news: Sequence[int],
    *,
    spec_tokens: int,
    chunk: int = 4,
    max_len: int = 64,
    page_tokens: Optional[int] = None,
    stats: Optional[Dict[str, int]] = None,
) -> List[List[int]]:
    """Batched speculative greedy decode, token-identical to the target
    alone.

    Mirrors the serving engine's step shape: every step runs ONE draft
    catch-up/prefill forward, ``k-1`` single-token draft proposals, and ONE
    ragged target forward in which verify rows (``q_len=k+1``), prefill
    chunk rows, plain decode rows and idle rows mix freely.  Rows speculate
    only once their draft cache has caught up with the committed sequence
    and ``k+1`` more positions fit under the row's cap; otherwise they
    decode one token per step while the draft catches up in the background.

    Args:
        target, target_params: verified model (any family), from
            ``build_model(cfg)``; the caches go on the device of
            ``target_params["embed"]`` (the draft's on its own).
        draft, draft_params: proposal model (any family; recurrent drafts
            use snapshot-restore instead of position rollback).
        prompts, max_news: per-row prompt tokens and output budgets.
        spec_tokens: draft tokens proposed per verify round (``k >= 1``).
        chunk: prefill/catch-up chunk width.
        max_len: KV capacity per row (both models).
        page_tokens: when set, the TARGET serves from a paged KV pool
            (per-row page tables, pages mapped up front to each row's cap);
            the draft always runs dense rows.
        stats: optional dict accumulating ``proposed`` / ``accepted`` /
            ``rounds`` counts across the serve.

    Returns:
        Per-row emitted token lists (length ``max_news[i]``).
    """
    assert spec_tokens >= 1
    b, k = len(prompts), spec_tokens
    tdev = target_params["embed"].device
    ddev = draft_params["embed"].device

    table = None
    if page_tokens is not None:
        from repro_torch.serving.kv_pool import KVPool

        pool = KVPool(b, max_len, page_tokens, prefix_sharing=False)
        caps = []
        for i, p in enumerate(prompts):
            # the verify overshoot writes up to cap positions, so map pages
            # for the full budget + one round of speculation
            head = min(len(p) + max_news[i] + k + 1, max_len)
            pool.alloc_sequence(i, list(p), head)
            caps.append(head)
        tcaches = target.init_paged_cache(pool.num_pages, page_tokens, b, tdev)
        table = torch.from_numpy(pool.table_array()).to(tdev)
    else:
        caps = [max_len] * b
        tcaches = target.init_cache(b, max_len, tdev)
    dcaches = draft.init_cache(b, max_len, ddev)
    t_state = recurrent_state(target.cfg, tcaches)
    d_state = recurrent_state(draft.cfg, dcaches)

    s0 = max(chunk, k + 1, 2)         # draft catch-up / prefill width
    out: List[List[int]] = [[] for _ in range(b)]
    finished = [False] * b
    tp = [0] * b                      # target prefill progress
    dpos = [0] * b                    # committed tokens the draft has consumed
    steps = 0
    while not all(finished):
        steps += 1
        assert steps < 10_000, "speculative loop stalled"

        committed = [list(prompts[i]) + out[i] for i in range(b)]
        spec_rows: List[int] = []
        dec_rows: List[int] = []
        pf: Dict[int, int] = {}
        for i in range(b):
            if finished[i]:
                continue
            if tp[i] < len(prompts[i]):
                pf[i] = min(chunk, len(prompts[i]) - tp[i])
                continue
            fed = len(committed[i]) - 1
            behind = len(committed[i]) - dpos[i]
            if behind <= s0 and fed + k + 1 <= caps[i]:
                spec_rows.append(i)
            else:
                dec_rows.append(i)

        # ---- draft: one catch-up forward, then k-1 proposals -------------
        proposals: Dict[int, List[int]] = {}
        toks0 = np.zeros((b, s0), np.int32)
        q0 = np.zeros(b, np.int32)
        pos0 = np.zeros(b, np.int32)
        feed_len = [0] * b
        for i in range(b):
            if finished[i]:
                continue
            # spec rows feed up to the full committed length (the last
            # row's logits ARE the first proposal); everyone else chips
            # away at the backlog, stopping one short so spec entry
            # always has a token to feed
            hi = len(committed[i]) if i in spec_rows else len(committed[i]) - 1
            n = min(s0, hi - dpos[i])
            if n <= 0:
                continue
            toks0[i, :n] = committed[i][dpos[i]:dpos[i] + n]
            q0[i], pos0[i], feed_len[i] = n, dpos[i], n
        if any(feed_len):
            logits0, dcaches = draft.fused_step(
                draft_params, {"tokens": torch.from_numpy(toks0).to(ddev)}, dcaches, pos0, q0,
            )
            nxt0 = logits0.argmax(-1).cpu().numpy()
            for i in range(b):
                dpos[i] += feed_len[i]
            for i in spec_rows:
                proposals[i] = [int(nxt0[i, feed_len[i] - 1])]
        dsnap = snapshot(d_state) if spec_rows and d_state is not None else None
        for _ in range(k - 1):
            if not spec_rows:
                break
            toks1 = np.zeros((b, 1), np.int32)
            q1 = np.zeros(b, np.int32)
            pos1 = np.zeros(b, np.int32)
            for i in spec_rows:
                toks1[i, 0] = proposals[i][-1]
                q1[i] = 1
                pos1[i] = dpos[i] + len(proposals[i]) - 1
            logits1, dcaches = draft.fused_step(
                draft_params, {"tokens": torch.from_numpy(toks1).to(ddev)}, dcaches, pos1, q1,
            )
            nxt1 = logits1[:, 0].argmax(-1).cpu().numpy()
            for i in spec_rows:
                proposals[i].append(int(nxt1[i]))

        # ---- target: one ragged forward over verify/prefill/decode rows --
        s = max(chunk, k + 1) if (pf or spec_rows) else 1
        toks = np.zeros((b, s), np.int32)
        q_lens = np.zeros(b, np.int32)
        cache_pos = np.zeros(b, np.int32)
        for i in range(b):
            if finished[i]:
                continue
            if i in pf:
                n = pf[i]
                toks[i, :n] = prompts[i][tp[i]:tp[i] + n]
                q_lens[i], cache_pos[i] = n, tp[i]
            elif i in proposals:
                toks[i, 0] = out[i][-1]
                toks[i, 1:k + 1] = proposals[i]
                q_lens[i] = k + 1
                cache_pos[i] = len(committed[i]) - 1
            else:
                toks[i, 0] = out[i][-1]
                q_lens[i] = 1
                cache_pos[i] = len(committed[i]) - 1
        # the commit pass below re-runs from the pre-verify recurrent state,
        # which the verify forward overwrites in place
        tsnap = snapshot(t_state) if proposals and t_state is not None else None
        tok_t = {"tokens": torch.from_numpy(toks).to(tdev)}
        logits, tcaches = target.fused_step(
            target_params, tok_t, tcaches, cache_pos, q_lens, page_table=table,
        )
        nxt = logits.argmax(-1).cpu().numpy()

        # ---- accept + emit ----------------------------------------------
        accepted: Dict[int, int] = {}
        for i in list(proposals):
            preds = [int(t) for t in nxt[i, :k + 1]]
            j, emitted = greedy_accept(proposals[i], preds)
            accepted[i] = j
            if stats is not None:
                stats["proposed"] = stats.get("proposed", 0) + k
                stats["accepted"] = stats.get("accepted", 0) + j
                stats["rounds"] = stats.get("rounds", 0) + 1
            for t in emitted:
                out[i].append(t)
                if len(out[i]) >= max_news[i]:
                    finished[i] = True
                    break
            if d_state is None:
                dpos[i] = rolled_back_draft_pos(len(committed[i]), j, k)
            # (a recurrent draft re-syncs by the snapshot restore below)
        for i in dec_rows:
            out[i].append(int(nxt[i, 0]))
            if len(out[i]) >= max_news[i]:
                finished[i] = True
        for i in pf:
            tp[i] += pf[i]
            if tp[i] == len(prompts[i]):
                out[i].append(int(nxt[i, pf[i] - 1]))
                if len(out[i]) >= max_news[i]:
                    finished[i] = True

        # ---- commit / rollback ------------------------------------------
        if tsnap is not None:
            # re-run ONLY the accepted span of each verify row (plus every
            # other row's feed unchanged) from the pre-verify state:
            # dt-masking freezes the recurrence exactly at q_len, so the
            # committed state never saw a rejected token
            restore(t_state, tsnap)
            q_commit = q_lens.copy()
            for i, j in accepted.items():
                q_commit[i] = j + 1
            _, tcaches = target.fused_step(
                target_params, tok_t, tcaches, cache_pos, q_commit, page_table=table,
            )
        if proposals and dsnap is not None:
            restore(d_state, dsnap)
            for i in accepted:
                dpos[i] = min(dpos[i], len(committed[i]))
    return out

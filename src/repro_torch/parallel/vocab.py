"""The vocabulary's two ends on a mesh: the embedding gather and the
cross-entropy, each over a vocab-sharded table without gathering it.

DTensor's own rules would all-gather the whole table for ``embed[tokens]``
(``[V, d]``: 525 MB of bf16 at llama3.2-1b) and the whole logits for
``logsumexp`` on every step.  Here each rank works on its vocab rows and
the model group sums what it found (Megatron's vocab-parallel embedding
and loss):

* :func:`embed_lookup` — rows of the local shard for the tokens that fall
  in it, zeros elsewhere, summed over the vocab group;
* :func:`cross_entropy_parts` — the per-token ``lse`` and gold logit from
  a group max, a group sum of ``exp`` and a group sum of the gold logit,
  reduced to the three sums the reference's loss is made of.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.launch.mesh import contiguous_strides

from . import collectives
from .context import like_batch


def _vocab_dims(placements, dim: int):
    """The mesh dims that shard tensor dim ``dim``."""
    return [m for m, p in enumerate(placements) if p.is_shard(dim)]


def _batch_placements(placements_of_tokens, n_mesh_dims: int):
    from torch.distributed.tensor import Replicate

    if placements_of_tokens is None:
        return [Replicate()] * n_mesh_dims
    return list(placements_of_tokens)


def embed_lookup(embed, tokens) -> "torch.Tensor":
    """``embed[tokens]`` for a DTensor ``embed`` ``[V, d]`` (vocab rows
    sharded over at most one mesh dim, replicated otherwise) and token ids
    ``[B, S]`` (a DTensor sharded on the batch, or a plain tensor held by
    every rank).  The result ``[B, S, d]`` takes the tokens' placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = embed.device_mesh
    tok_pl = tokens.placements if isinstance(tokens, DTensor) else None
    out_pl = _batch_placements(tok_pl, mesh.ndim)
    if any(isinstance(p, Shard) and p.dim != 0 for p in out_pl):
        raise NotImplementedError(f"tokens placed {tok_pl}: only the batch dim is sharded")
    vdims = _vocab_dims(embed.placements, 0)
    if len(vdims) > 1:
        raise NotImplementedError("an embedding sharded over more than one mesh dim")
    # the table's gradient is partial over the dims that split the batch
    grad_pl = [
        Partial() if (p == Replicate() and out_pl[m] != Replicate()) else p
        for m, p in enumerate(embed.placements)
    ]
    table = embed.to_local(grad_placements=grad_pl)
    tok = tokens.to_local() if tok_pl is not None else tokens
    tok = tok.to(device=table.device, dtype=torch.int64)
    if not vdims:
        x = table[tok]
    else:
        m = vdims[0]
        rows = table.shape[0]
        idx = tok - mesh.get_local_rank(m) * rows
        inside = (idx >= 0) & (idx < rows)
        x = table[idx.clamp(0, rows - 1)]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        x = collectives.all_reduce(x, mesh.get_group(m))
    shape = tuple(tokens.shape) + (embed.shape[1],)
    return DTensor.from_local(x, mesh, out_pl, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def cross_entropy_parts(logits, labels) -> Tuple["torch.Tensor", ...]:
    """For DTensor ``logits`` ``[B, S, V]`` (batch and vocab sharded) and
    ``labels`` ``[B, S]`` (−1 = ignore): the DTensor scalars
    ``(Σ nll·mask, Σ (lse·mask)², Σ mask)`` over the global batch, each
    still partial over the batch's mesh dims — DTensor sums them when they
    are combined — with fp32 math as in ``cross_entropy_loss``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = logits.device_mesh
    vdims = _vocab_dims(logits.placements, logits.ndim - 1)
    if len(vdims) > 1:
        raise NotImplementedError("logits sharded over more than one mesh dim on the vocab")
    if not isinstance(labels, DTensor):          # the whole batch's: keep this rank's rows
        labels = like_batch(torch.as_tensor(labels).to(logits.device), logits)
    lab_pl = labels.placements
    x = logits.to_local().float()
    lab = labels.to_local().to(device=x.device, dtype=torch.int64)
    mask = (lab >= 0).to(torch.float32)
    gold_idx = lab.clamp_min(0)
    if vdims:
        m = vdims[0]
        group = mesh.get_group(m)
        cols = x.shape[-1]
        top = collectives.all_max(x.amax(dim=-1), group)
        sumexp = collectives.all_reduce(torch.exp(x - top[..., None]).sum(dim=-1), group)
        lse = top + torch.log(sumexp)
        idx = gold_idx - mesh.get_local_rank(m) * cols
        inside = (idx >= 0) & (idx < cols)
        gold = torch.gather(x, -1, idx.clamp(0, cols - 1)[..., None])[..., 0]
        gold = collectives.all_reduce(torch.where(inside, gold, torch.zeros_like(gold)), group)
    else:
        lse = torch.logsumexp(x, dim=-1)
        gold = torch.gather(x, -1, gold_idx[..., None])[..., 0]
    nll = lse - gold
    parts = ((nll * mask).sum(), ((lse * mask) ** 2).sum(), mask.sum())
    # each rank summed its own rows: partial over the mesh dims that split
    # the batch, whole (replicated) over the others
    out_pl = [Partial() if p != Replicate() else Replicate() for p in lab_pl]
    return tuple(DTensor.from_local(t, mesh, out_pl, run_check=False) for t in parts)


def greedy_tokens(logits) -> "torch.Tensor":
    """``argmax`` over the last dim (the vocab) of DTensor ``logits``
    ``[..., V]``, int32: each rank's best column of its vocab shard, then
    the group's best (the first index among equal maxima, as
    ``torch.argmax``).  The result takes the logits' batch placements,
    whole over the vocab's mesh dims.  DTensor's own rule reads shard
    offsets on the host, which a fake tensor cannot give."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = logits.device_mesh
    vdims = _vocab_dims(logits.placements, logits.ndim - 1)
    if len(vdims) > 1:
        raise NotImplementedError("logits sharded over more than one mesh dim on the vocab")
    x = logits.to_local()
    best, idx = x.max(dim=-1)
    if vdims:
        m = vdims[0]
        group = mesh.get_group(m)
        idx = idx + mesh.get_local_rank(m) * -(-logits.shape[-1] // mesh.size(m))
        top = collectives.all_max(best.float(), group)
        # the smallest index holding the max: a max of the negated indices
        miss = torch.full_like(idx, -(1 << 62))
        idx = -collectives.all_max(torch.where(best.float() == top, -idx, miss), group)
    out_pl = [Replicate() if m in vdims else p for m, p in enumerate(logits.placements)]
    shape = logits.shape[:-1]
    return DTensor.from_local(idx.to(torch.int32), mesh, out_pl, run_check=False, shape=shape,
                              stride=contiguous_strides(shape))

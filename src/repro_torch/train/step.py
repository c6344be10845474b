"""train_step / serve_step factories of the port.

``make_train_step`` supports gradient accumulation (a loop over
micro-batches, the counterpart of the reference's ``lax.scan``) so
activation memory stays bounded at large global batches; gradients
accumulate in the params' dtype, as in the reference.

Training runs the plain PyTorch paths under autograd.  A config that
selects the hand-written kernels (``attention_impl="pallas"``) is refused:
the kernels are forward-only, and the reference has no backward kernel
either (its jitted step trains on ``chunked``).

Under a :func:`~repro_torch.parallel.context.parallel_context` whose mesh
holds the ranks, the step is the sharded one: params are DTensors
(:func:`~repro_torch.parallel.sharding.param_shardings`), each
(micro-)batch is cut over the ranks by ``batch_pspecs``, the loss is the
global one, and the gradients' partial sums over the batch's ranks are
reduced into the ZeRO-1 moments' layout by the update.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.model import Model, cross_entropy_loss
from repro_torch.models.transformer import check_trainable
from repro_torch.parallel.context import current_context, is_dtensor
from repro_torch.parallel.sharding import batch_pspecs, distribute
from repro_torch.parallel.vocab import greedy_tokens
from .optimizer import AdamWConfig, adamw_update, decay_mask
from .tree import leaves, tree_map


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, aux = model.train_forward(params, batch)
        return cross_entropy_loss(logits, batch["labels"], aux_loss=aux)

    return loss_fn


def stacked_groups(cfg) -> Tuple[str, ...]:
    """The layer groups the reference stores stacked ``[L, ...]``: the
    hybrid's Mamba layers always, the layer lists when ``scan_layers``."""
    groups = ("mamba_layers",)
    return groups + (("layers", "encoder", "decoder") if cfg.scan_layers else ())


def _on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (DTensors, already on
    the mesh, as they are)."""
    return {k: v if is_dtensor(v) else torch.as_tensor(v).to(device) for k, v in batch.items()}


def _rows(batch: Dict[str, torch.Tensor]) -> int:
    return batch["embeds" if "embeds" in batch else "tokens"].shape[0]


def _micro(batch: Dict[str, torch.Tensor], i: int, n: int) -> Dict[str, torch.Tensor]:
    """Micro-batch ``i`` of ``n``: rows on axis 0, or axis 1 for the
    ``[3, B, S]`` M-RoPE ``positions``."""
    out = {}
    for k, x in batch.items():
        axis = 1 if k == "positions" else 0
        if is_dtensor(x):
            # a batch already on the mesh: micro-batch i of each rank's rows
            from torch.distributed.tensor import DTensor

            from repro_torch.launch.mesh import contiguous_strides

            local = x.to_local()
            size = local.shape[axis] // n
            shape = list(x.shape)
            shape[axis] //= n
            out[k] = DTensor.from_local(
                local.narrow(axis, i * size, size), x.device_mesh, x.placements,
                run_check=False, shape=torch.Size(shape),
                stride=contiguous_strides(shape))
            continue
        size = x.shape[axis] // n
        out[k] = x.narrow(axis, i * size, size)
    return out


def _distribute(batch: Dict[str, torch.Tensor], cfg, rows: int) -> Dict[str, torch.Tensor]:
    """Under a context on a real mesh: the batch's arrays (the same on
    every rank) as DTensors cut by ``batch_pspecs`` for a global batch of
    ``rows`` (DTensors as they are); otherwise ``batch`` itself."""
    ctx = current_context()
    if ctx is None or ctx.mesh is None or ctx.mesh.device_mesh is None:
        return batch
    x = batch["embeds" if "embeds" in batch else "tokens"]
    shape = ShapeConfig("step", seq_len=x.shape[1], global_batch=rows, kind="train")
    specs = batch_pspecs(cfg, shape, ctx.mesh)
    return {k: distribute(v, ctx.mesh, specs[k]) if k in specs and not is_dtensor(v) else v
            for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): ``grads`` a tree like ``params``, each gradient in
    its param's dtype; zeros for a param the loss does not reach (the VLM's
    token embedding, when embeddings come in), as ``jax.grad`` gives.  A
    DTensor loss is taken whole (``full_tensor``); DTensor gradients come
    as autograd leaves them, partial sums included."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(live, batch)
    if is_dtensor(loss):
        loss = loss.full_tensor()
    grads = iter(torch.autograd.grad(loss, leaves(live), allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, live)


def make_train_pieces(model: Model, opt_cfg: AdamWConfig, *, accum_steps: int = 1):
    """The train step in its pieces, ``(start, micro, finish)``:

    * ``start(params, batch) -> acc``: the batch onto the params' device,
      and the gradient accumulator (zeros, when ``accum_steps > 1``);
    * ``micro(params, acc, i) -> acc``: micro-batch ``i``'s forward and
      backward, its loss and gradients added into ``acc``;
    * ``finish(params, opt_state, acc)``: the mean over the micro-batches
      and the update, ``(new_params, new_opt, {"loss", "grad_norm"})``.

    :func:`make_train_step` is ``start``, ``accum_steps`` × ``micro`` and
    ``finish``; the dry-run's finite difference counts them apart."""
    check_trainable(model.cfg)
    loss_fn = make_loss_fn(model)
    stacked = stacked_groups(model.cfg)

    def start(params, batch):
        batch = _on(batch, leaves(params)[0].device)
        acc = {"batch": batch, "rows": _rows(batch), "loss": None, "grads": None}
        if accum_steps > 1:
            acc["grads"] = tree_map(torch.zeros_like, params)
            acc["loss"] = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
        return acc

    def micro(params, acc, i):
        batch, rows = acc["batch"], acc["rows"]
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, _distribute(batch, model.cfg, rows))
            return dict(acc, loss=loss, grads=grads)
        piece = _distribute(_micro(batch, i, accum_steps), model.cfg, rows)
        l, g = value_and_grad(loss_fn, params, piece)
        return dict(acc, loss=acc["loss"] + l,
                    grads=tree_map(lambda a, b: a + b, acc["grads"], g))

    def finish(params, opt_state, acc):
        loss, grads = acc["loss"], acc["grads"]
        if accum_steps > 1:
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
        new_params, new_opt, gnorm = adamw_update(
            opt_cfg, params, grads, opt_state, decay=decay_mask(params, stacked))
        if is_dtensor(gnorm):
            gnorm = gnorm.full_tensor()
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return start, micro, finish


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    *,
    accum_steps: int = 1,
) -> Callable:
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    {"loss", "grad_norm"})``; the batch's arrays (numpy or tensors) go to
    the params' device.  Raises ``ValueError`` for a kernel config."""
    start, micro, finish = make_train_pieces(model, opt_cfg, accum_steps=accum_steps)

    def train_step(params, opt_state, batch):
        acc = start(params, batch)
        for i in range(accum_steps):
            acc = micro(params, acc, i)
        return finish(params, opt_state, acc)

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def serve_step(params, token_batch, caches, cache_pos):
        logits, new_caches = model.decode_step(params, token_batch, caches, cache_pos)
        if is_dtensor(logits):
            next_tok = greedy_tokens(logits)
        else:
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, new_caches

    return serve_step

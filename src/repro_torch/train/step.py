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
    """The batch's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _rows(batch: Dict[str, torch.Tensor]) -> int:
    return batch["embeds" if "embeds" in batch else "tokens"].shape[0]


def _micro(batch: Dict[str, torch.Tensor], i: int, n: int) -> Dict[str, torch.Tensor]:
    """Micro-batch ``i`` of ``n``: rows on axis 0, or axis 1 for the
    ``[3, B, S]`` M-RoPE ``positions``."""
    out = {}
    for k, x in batch.items():
        axis = 1 if k == "positions" else 0
        size = x.shape[axis] // n
        out[k] = x.narrow(axis, i * size, size)
    return out


def _distribute(batch: Dict[str, torch.Tensor], cfg, rows: int) -> Dict[str, torch.Tensor]:
    """Under a context on a real mesh: the batch's arrays (the same on
    every rank) as DTensors cut by ``batch_pspecs`` for a global batch of
    ``rows``; otherwise ``batch`` itself."""
    ctx = current_context()
    if ctx is None or ctx.mesh is None or ctx.mesh.device_mesh is None:
        return batch
    x = batch["embeds" if "embeds" in batch else "tokens"]
    shape = ShapeConfig("step", seq_len=x.shape[1], global_batch=rows, kind="train")
    specs = batch_pspecs(cfg, shape, ctx.mesh)
    return {k: distribute(v, ctx.mesh, specs[k]) if k in specs else v for k, v in batch.items()}


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


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    *,
    accum_steps: int = 1,
) -> Callable:
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    {"loss", "grad_norm"})``; the batch's arrays (numpy or tensors) go to
    the params' device.  Raises ``ValueError`` for a kernel config."""
    check_trainable(model.cfg)
    loss_fn = make_loss_fn(model)
    stacked = stacked_groups(model.cfg)

    def train_step(params, opt_state, batch):
        batch = _on(batch, leaves(params)[0].device)
        rows = _rows(batch)
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, _distribute(batch, model.cfg, rows))
        else:
            grads = tree_map(torch.zeros_like, params)
            loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            for i in range(accum_steps):
                micro = _distribute(_micro(batch, i, accum_steps), model.cfg, rows)
                l, g = value_and_grad(loss_fn, params, micro)
                grads = tree_map(lambda a, b: a + b, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
        new_params, new_opt, gnorm = adamw_update(
            opt_cfg, params, grads, opt_state, decay=decay_mask(params, stacked))
        if is_dtensor(gnorm):
            gnorm = gnorm.full_tensor()
        metrics = {"loss": loss, "grad_norm": gnorm}
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def serve_step(params, token_batch, caches, cache_pos):
        logits, new_caches = model.decode_step(params, token_batch, caches, cache_pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, new_caches

    return serve_step

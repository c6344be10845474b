"""Mamba2 (SSD — state-space duality) block of the port, in PyTorch.

The chunked SSD algorithm of arXiv:2405.21060, as the reference's
``repro/models/ssm.py`` runs it:

  within chunk:  Y_diag = (C Bᵀ ⊙ L) · (dt·x)        L = exp(segsum(dt·A))
  chunk states:  S_c    = Σ_j exp(cum_L − cum_j) (dt_j x_j) ⊗ B_j
  across chunks: S_c⁺   = S_{c-1} e^{Σ dt·A} + S_c
  offset:        Y_off  = C_i · S_{c-1} · e^{cum_i}

:func:`ssd_chunked` runs it through the hand-written CUDA kernel's wrapper
(``kernel=True``, :mod:`repro_torch.kernels.ssd_scan`) or its plain
version.  Decode keeps the recurrent form in plain PyTorch, as the
reference keeps it in jnp: state ← state·e^{dt·A} + dt·x⊗B, y = C·state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.parallel import collectives
from .layers import rmsnorm

Params = Dict[str, Any]


def mamba2_dims(cfg: ModelConfig) -> Dict[str, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_ch = d_inner + 2 * cfg.ngroups * cfg.ssm_state
    return dict(
        d_inner=d_inner,
        nheads=nheads,
        conv_ch=conv_ch,
        d_in_proj=2 * d_inner + 2 * cfg.ngroups * cfg.ssm_state + nheads,
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B,S,C], w [W,C] → [B,S,C], as a sum of W
    shifted slices."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    s = x.shape[1]
    for i in range(width):
        out = out + xp[:, i : i + s, :] * w[i]
    return out + b


def ssd_chunked(
    x: torch.Tensor,       # [B, S, H, P]
    dt: torch.Tensor,      # [B, S, H]  (post-softplus, fp32)
    A: torch.Tensor,       # [H]        (negative, fp32)
    B_: torch.Tensor,      # [B, S, G, N]
    C_: torch.Tensor,      # [B, S, G, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N] fp32
    *,
    kernel: bool = False,
    out_state: Optional[torch.Tensor] = None,    # [B, H, P, N] fp32, may be init_state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,H,P], final_state [B,H,P,N] fp32); the final state
    is written into ``out_state`` when one is given.  ``kernel=True`` goes
    through the CUDA kernel's wrapper (which runs the same plain function
    on a CPU tensor)."""
    if kernel:
        return ssd_kernel.ssd_scan(x, dt, A, B_, C_, chunk, init_state, out_state)
    y, final = ssd_kernel.ssd_scan_plain(x, dt, A, B_, C_, chunk, init_state)
    if out_state is None:
        return y, final
    return y, out_state.copy_(final)


def mamba2_block(
    p: Params,
    xin: torch.Tensor,             # [B, S, D]
    cfg: ModelConfig,
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,   # {"conv_x","conv_B","conv_C","ssm"}
    seq_lens: Optional[torch.Tensor] = None,  # [B] valid tokens per row (fused
                                              # mixed batch; requires state)
    kernel: bool = False,
    ssm_out: Optional[torch.Tensor] = None,   # [B, H, P, N] fp32: the scan's final
                                              # state goes here (may be state["ssm"])
    norm_group=None,                          # the process group cutting the heads
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One Mamba2 block; returns (out, new_state).  Three paths: a fresh
    prefill (``state=None``), a chunk continuation from ``state``
    (``S > 1``, optionally ragged through ``seq_lens``) and the
    single-token recurrent step.  ``kernel=True`` runs the SSD scan and
    the gated RMSNorm through the CUDA kernels' wrappers.

    The heads are those of ``p``: on a mesh that cuts them (``norm_group``,
    the ranks that share the block), ``p`` holds this rank's columns of
    w_z, w_x, w_dt, conv_x, b_x, norm_w, its heads of A_log, D and dt_bias,
    its rows of out_proj, and w_B, w_C, conv_B/C whole; the block then runs
    on those heads (the state too is theirs), its gated norm reduces over
    the group (:func:`gated_norm`), and the output is this rank's partial
    sum of ``y @ out_proj``."""
    b, s, _ = xin.shape
    h, pdim, n, g = p["A_log"].shape[0], cfg.ssm_headdim, cfg.ssm_state, cfg.ngroups
    if g > 1 and h != mamba2_dims(cfg)["nheads"]:
        raise NotImplementedError("a Mamba2 block cut by heads takes one B/C group")
    A = -torch.exp(p["A_log"])

    z = xin @ p["w_z"]
    xr = xin @ p["w_x"]
    Br = xin @ p["w_B"]
    Cr = xin @ p["w_C"]
    dt = F.softplus((xin @ p["w_dt"]).float() + p["dt_bias"])
    if seq_lens is not None and state is not None:
        # ragged rows: tokens beyond a row's seq_len are EXACT state no-ops
        # in the SSD recurrence — dt=0 means decay exp(0·A)=1 and a zero
        # dt-weighted input — so masking dt freezes the ssm state through
        # padding (conv tails are gathered per row below)
        dt = dt * (torch.arange(s, device=xin.device)[None, :, None] < seq_lens[:, None, None])

    width = p["conv_x"].shape[0]
    if state is None:
        # conv tails for the prefill→decode hand-off: last W-1 pre-conv inputs
        def tail_of(v):
            return F.pad(v, (0, 0, max(width - 1 - s, 0), 0))[:, -(width - 1):]

        tails = {"x": tail_of(xr), "B": tail_of(Br), "C": tail_of(Cr)}
        xc = F.silu(_causal_conv(xr, p["conv_x"], p["b_x"]))
        Bc = F.silu(_causal_conv(Br, p["conv_B"], p["b_B"]))
        Cc = F.silu(_causal_conv(Cr, p["conv_C"], p["b_C"]))
        xs = xc.reshape(b, s, h, pdim)
        y, final = ssd_chunked(
            xs, dt, A, Bc.reshape(b, s, g, n), Cc.reshape(b, s, g, n), cfg.ssm_chunk,
            kernel=kernel, out_state=ssm_out,
        )
        new_state = {"ssm": final, "conv_x": tails["x"], "conv_B": tails["B"], "conv_C": tails["C"]}
    elif s > 1:
        # chunked-prefill continuation: the causal conv's left context is the
        # previous chunk's last W-1 pre-activation inputs (the stored tails),
        # and the SSD scan seeds from the carried ssm state
        def conv_cont(v_new, st, w, bias):
            full = torch.cat([st, v_new], dim=1)            # [B, W-1+s, ch]
            out = torch.zeros_like(v_new)
            for i in range(width):
                out = out + full[:, i : i + s, :] * w[i]
            if seq_lens is None:
                tail = full[:, full.shape[1] - (width - 1):]
            else:
                # per-row tail: the last W-1 inputs BEFORE padding, which sit
                # at seq_len + m (m = 0..W-2) in ``full``; an idle row
                # (seq_len = 0) keeps its old tail verbatim
                idx = seq_lens.long()[:, None] + torch.arange(width - 1, device=full.device)
                tail = torch.gather(full, 1, idx[:, :, None].expand(-1, -1, full.shape[2]))
            return F.silu(out + bias), tail

        xc, new_cx = conv_cont(xr, state["conv_x"], p["conv_x"], p["b_x"])
        Bc, new_cB = conv_cont(Br, state["conv_B"], p["conv_B"], p["b_B"])
        Cc, new_cC = conv_cont(Cr, state["conv_C"], p["conv_C"], p["b_C"])
        xs = xc.reshape(b, s, h, pdim)
        y, final = ssd_chunked(
            xs, dt, A, Bc.reshape(b, s, g, n), Cc.reshape(b, s, g, n), cfg.ssm_chunk,
            init_state=state["ssm"], kernel=kernel, out_state=ssm_out,
        )
        new_state = {"ssm": final, "conv_x": new_cx, "conv_B": new_cB, "conv_C": new_cC}
    else:
        # single-token recurrent step: s == 1
        def conv_step(v_new, st, w, bias):
            full = torch.cat([st, v_new], dim=1)            # [B, W, ch]
            out = (full * w[None]).sum(dim=1, keepdim=True) + bias
            tail = full[:, 1:]
            if seq_lens is not None:
                # idle rows (seq_len = 0) must not shift their conv tail
                tail = torch.where((seq_lens > 0)[:, None, None], tail, st)
            return F.silu(out), tail

        xc, new_cx = conv_step(xr, state["conv_x"], p["conv_x"], p["b_x"])
        Bc, new_cB = conv_step(Br, state["conv_B"], p["conv_B"], p["b_B"])
        Cc, new_cC = conv_step(Cr, state["conv_C"], p["conv_C"], p["b_C"])
        xs = xc.reshape(b, 1, h, pdim)
        rep = h // g
        Bh = Bc.reshape(b, g, n).repeat_interleave(rep, dim=1)     # [B,H,N]
        Ch = Cc.reshape(b, g, n).repeat_interleave(rep, dim=1)
        dt1 = dt[:, 0]                                              # [B,H]
        dec = torch.exp(dt1 * A)
        ssm = state["ssm"].float()
        xw = xs[:, 0].float() * dt1[..., None]                      # [B,H,P]
        ssm = ssm * dec[..., None, None] + torch.einsum("bhp,bhn->bhpn", xw, Bh.float())
        y = torch.einsum("bhpn,bhn->bhp", ssm, Ch.float())[:, None]
        y = y.to(xin.dtype)
        new_state = {"ssm": ssm, "conv_x": new_cx, "conv_B": new_cB, "conv_C": new_cC}

    y = y + xs.to(y.dtype) * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(b, s, h * pdim)
    y = gated_norm(y, z, p["norm_w"], kernel=kernel, group=norm_group)
    return y @ p["out_proj"], new_state


def gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, *, kernel: bool = False,
               group=None, eps: float = 1e-6) -> torch.Tensor:
    """mamba2's gated RMSNorm (the norm before out_proj, gated by z) over
    the block's whole d_inner.  ``group``: the ranks over which d_inner is
    cut, each holding its own columns of ``y``, ``z`` and ``w``.  Each rank
    sums its columns' squares, the ``[B, S, 1]`` sums are all-reduced over
    the group (the all-reduce the reference's partitioner places there;
    their gradient is summed too, each rank having used the sums for its
    own columns) and each rank scales its own columns — so on such a mesh
    this norm is plain PyTorch, not an RMSNorm-kernel launch: the kernel
    takes its rows whole."""
    u = y * F.silu(z)
    if group is None:
        return rmsnorm(u, w, kernel=kernel)
    uf = u.float()
    sq = collectives.all_reduce((uf * uf).sum(dim=-1, keepdim=True), group, reduce_grad=True)
    width = u.shape[-1] * dist.get_world_size(group)
    return (uf * torch.rsqrt(sq / width + eps) * (1.0 + w.float())).to(u.dtype)


STATE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Zero recurrent state of one Mamba2 layer: conv tails ``[B, W-1, ch]``
    in ``dtype``, the ssm state ``[B, H, P, N]`` in fp32."""
    dims = mamba2_dims(cfg)
    gn = cfg.ngroups * cfg.ssm_state
    w1 = cfg.ssm_conv - 1
    return {
        "conv_x": torch.zeros((batch, w1, dims["d_inner"]), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w1, gn), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w1, gn), dtype=dtype, device=device),
        "ssm": torch.zeros(
            (batch, dims["nheads"], cfg.ssm_headdim, cfg.ssm_state),
            dtype=torch.float32, device=device,
        ),
    }


def stacked_init_state(cfg: ModelConfig, batch: int, dtype, device, layers: int) -> Dict[str, torch.Tensor]:
    """:func:`mamba2_init_state` for ``layers`` layers on a leading axis, as
    real storage (the reference broadcasts) so the forward can write each
    layer's slice in place."""
    st = mamba2_init_state(cfg, batch, dtype, device)
    return {k: v.new_zeros((layers,) + tuple(v.shape)) for k, v in st.items()}


def layer_state(stack: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s state: views into the stacked tensors."""
    return {k: stack[k][i] for k in STATE_KEYS}


def store_state(stack: Dict[str, torch.Tensor], i: int, new: Dict[str, torch.Tensor]) -> None:
    """Write layer ``i``'s new state into the stacked tensors in place (a
    leaf the scan already wrote there is left as it is)."""
    for k in STATE_KEYS:
        dst = stack[k][i]
        src = new[k]
        if not (src.untyped_storage()._cdata == dst.untyped_storage()._cdata
                and src.storage_offset() == dst.storage_offset() and src.shape == dst.shape):
            dst.copy_(src)

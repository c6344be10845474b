"""The port's roofline tools (``repro_torch.launch.roofline``,
``repro_torch.launch.roofline_fd``) against the JAX reference's, on the
CPU.

* ``roofline_terms`` is the reference's arithmetic: the cases of
  ``tests/test_roofline_tools.py`` against the H100 constants, and, with
  the reference's TPU v5e constants swapped in, the reference's function's
  result on the same cell.
* ``roofline_fd`` rebuilds the direct full-depth count exactly — FLOPs,
  bytes and collective bytes — for a dense config, gemma2's local/global
  pattern (a unit of 2 layers), zamba2's shared-attention unit and the
  enc-dec stack, at train, prefill and decode (smoke widths, a (2 × 4)
  mesh of fake ranks).
* Per-layer-unit FLOPs at ``naive`` attention against the reference's
  ``_measure(...)["flops"]`` on the same (2 × 4) mesh (8 forced CPU
  devices, Auto axes; a subprocess), llama3.2-1b's smoke config.  Measured
  ratios port / reference: prefill 0.968, decode 0.962 and train (forward
  and backward) 0.960 — XLA also counts elementwise FLOPs, the port's
  counter only the products.  The train step's products stay cut because
  each shard hint lays out the gradient that reaches it as it lays out
  the activation (the transpose of ``with_sharding_constraint``): a
  partial-sum gradient is all-reduced at the hint, not met by a
  column-cut weight, which DTensor would gather to multiply at full width
  (1.536 before the hints constrained the gradient, ``PERF.md`` §6).
* The grouped GEMM's custom op: its fake implementation, its FLOP formula
  (``2·M·K·N``, the dense count), and its gradient (the plain loop's).
* A fake CUDA tensor handed to a kernel wrapper raises.
"""

from dataclasses import replace

import pytest
import torch

from _torch_ranks import start_reference
from repro.configs import get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import roofline as j_roofline
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline, roofline_fd
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS_BF16, StepCounter

# ------------------------------------------------------------ terms


def test_terms_are_h100s():
    from repro_torch.core.devices import H100_HBM_BW, H100_NVLINK_BW, H100_PEAK_BF16

    assert (PEAK_FLOPS_BF16, HBM_BW, LINK_BW) == (H100_PEAK_BF16, H100_HBM_BW, H100_NVLINK_BW)
    assert (PEAK_FLOPS_BF16, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)


def test_roofline_terms_math():
    cfg = t_get_config("llama3.2-1b")
    shape = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
    cell = {
        "flops_per_device": PEAK_FLOPS_BF16,        # exactly 1s of compute
        "bytes_per_device": HBM_BW * 2,             # 2s of memory
        "collective_bytes_per_device": LINK_BW * 0.5,
        "n_devices": 256,
        "active_params": 1_000_000,
    }
    terms = roofline.roofline_terms(cell, cfg, shape)
    assert terms["t_compute_s"] == pytest.approx(1.0)
    assert terms["t_memory_s"] == pytest.approx(2.0)
    assert terms["t_collective_s"] == pytest.approx(0.5)
    assert terms["dominant"] == "memory"
    assert terms["step_time_lb_s"] == pytest.approx(2.0)
    assert terms["model_flops"] == pytest.approx(6 * 1e6 * 256 * 4096)


def test_decode_model_flops_uses_one_token():
    cfg = t_get_config("llama3.2-1b")
    shape = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
    cell = {"flops_per_device": 1e12, "bytes_per_device": 1e9,
            "collective_bytes_per_device": 0.0, "n_devices": 256, "active_params": 1_000_000}
    terms = roofline.roofline_terms(cell, cfg, shape)
    assert terms["model_flops"] == pytest.approx(2 * 1e6 * 128)
    assert terms["dominant"] == "compute"


@pytest.mark.parametrize("kind,seq,batch", [("train", 4096, 256), ("prefill", 32768, 32),
                                            ("decode", 32768, 128)])
def test_roofline_terms_are_the_references_with_its_constants(monkeypatch, kind, seq, batch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16", j_roofline.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", j_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", j_roofline.ICI_BW)
    cell = {"flops_per_device": 3.7e13, "bytes_per_device": 2.1e11,
            "collective_bytes_per_device": 5.5e9, "n_devices": 256,
            "active_params": 2_700_000_000, "params": 14_300_000_000}
    want = j_roofline.roofline_terms(cell, get_config("qwen2-moe-a2.7b"),
                                     JShapeConfig(kind, seq_len=seq, global_batch=batch, kind=kind))
    got = roofline.roofline_terms(cell, t_get_config("qwen2-moe-a2.7b"),
                                  ShapeConfig(kind, seq_len=seq, global_batch=batch, kind=kind))
    assert got == want


# ------------------------------------------------------------ finite differences

FD_CASES = {
    "dense": ("llama3.2-1b", 3),
    "local-global": ("gemma2-27b", 6),         # unit 2: L1 2, L2 4, full 6
    "hybrid": ("zamba2-2.7b", 6),              # shared block every 2 (smoke)
    "encdec": ("seamless-m4t-large-v2", 3),    # encoder and decoder at 3
}
FD_SHAPES = {"train": (32, 8), "prefill": (32, 8), "decode": (64, 8)}


@pytest.mark.parametrize("kind", list(FD_SHAPES))
@pytest.mark.parametrize("case", list(FD_CASES))
def test_finite_difference_rebuilds_the_direct_count(case, kind):
    arch, layers = FD_CASES[case]
    cfg = t_get_config(arch).smoke()
    cfg = replace(cfg, n_layers=layers,
                  **({"n_encoder_layers": layers} if cfg.family == "encdec" else {}))
    s, b = FD_SHAPES[kind]
    r = roofline_fd.run_cell(arch, kind, device="cpu", check=True, mesh_shape=(2, 4), cfg=cfg,
                             shape=ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind))
    assert r["status"] == "ok" and r["n_devices"] == 8
    assert r["reconstruction_equal"], (r["direct"], r["flops_per_device"],
                                       r["bytes_per_device"], r["collective_bytes_per_device"])
    assert r["per_layer_unit"]["flops"] > 0 and r["per_layer_unit"]["bytes"] > 0
    if kind == "train":
        assert r["accum_steps"] == 1 and set(r["opt"]) == {"flops", "bytes", "coll"}


_REFERENCE_FLOPS = """
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.roofline_fd import _lower_cell, _measure, _with_layers

mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
OUT = {}
cfg = get_config(ARGS["arch"]).smoke()
for kind, (shape_kind, s, b) in ARGS["kinds"].items():
    shape = ShapeConfig(shape_kind, seq_len=s, global_batch=b, kind=shape_kind)
    f1, f2 = (_measure(_lower_cell(_with_layers(cfg, n), shape, mesh, kind))["flops"]
              for n in (1, 2))
    OUT[shape_kind] = f2 - f1
"""
FLOP_KINDS = {"prefill": ("prefill", 64, 8), "train_fwdbwd": ("train", 64, 8),
              "decode": ("decode", 128, 8)}
# port / reference, per layer (measured: 0.968, 0.960, 0.962)
FLOP_RATIO = {"prefill": (0.95, 1.0), "decode": (0.95, 1.0), "train": (0.95, 1.0)}


@pytest.fixture(scope="module")
def reference_layer_flops(tmp_path_factory):
    ref = start_reference(8, _REFERENCE_FLOPS, tmp_path_factory.mktemp("flops"),
                          {"arch": "llama3.2-1b", "kinds": FLOP_KINDS}, timeout=300)
    return ref.results()[0]


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
def test_layer_flops_against_reference(reference_layer_flops, kind):
    (_, s, b), = [v for v in FLOP_KINDS.values() if v[0] == kind]
    r = roofline_fd.run_cell("llama3.2-1b", kind, device="cpu", mesh_shape=(2, 4),
                             cfg=t_get_config("llama3.2-1b").smoke(),
                             shape=ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind))
    ratio = r["per_layer_unit"]["flops"] / reference_layer_flops[kind]
    lo, hi = FLOP_RATIO[kind]
    assert lo <= ratio <= hi, ratio


# ------------------------------------------------------------ grouped GEMM op


def test_grouped_gemm_op_fake_and_flops():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import grouped_gemm as gg

    with FakeTensorMode():
        x = torch.empty(40, 64, dtype=torch.bfloat16)
        w = torch.empty(4, 64, 24, dtype=torch.bfloat16)
        gs = torch.empty(4, dtype=torch.int32)        # unreadable on the host
        with StepCounter() as c:
            y = gg.grouped_gemm_plain(x, w, gs)
    assert tuple(y.shape) == (40, 24) and y.dtype == torch.bfloat16
    assert c.flops == 2 * 40 * 64 * 24


def test_grouped_gemm_op_gradient_is_the_loops():
    from repro_torch.kernels import grouped_gemm as gg

    g = torch.Generator().manual_seed(0)
    x = torch.randn(12, 16, generator=g)
    w = torch.randn(3, 16, 8, generator=g)
    gs = torch.tensor([5, 0, 4], dtype=torch.int32)    # rows 9..11 past the groups
    dy = torch.randn(12, 8, generator=g)

    def loop(x, w):
        out = torch.zeros(12, 8)
        out[0:5] = x[0:5] @ w[0]
        out[5:9] = x[5:9] @ w[2]
        return out

    got = [t.detach().requires_grad_() for t in (x, w)]
    want = [t.detach().requires_grad_() for t in (x, w)]
    with StepCounter() as c:
        gg.grouped_gemm_plain(*got, gs).backward(dy)
    loop(*want).backward(dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)
    assert c.flops == 3 * 2 * 12 * 16 * 8                 # forward, and dx and dw


@pytest.mark.parametrize("which", ["rmsnorm", "flash", "ssd_scan"])
def test_kernel_wrappers_refuse_fake_tensors(which):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd

    with FakeTensorMode():
        if which == "rmsnorm":
            call = lambda: rn.rmsnorm(torch.empty(4, 64, device="cuda"),  # noqa: E731
                                      torch.empty(64, device="cuda"))
        elif which == "flash":
            q = torch.empty(1, 4, 2, 64, device="cuda", dtype=torch.bfloat16)
            off = torch.zeros(1, dtype=torch.int32, device="cuda")
            call = lambda: fa.flash_attention(q, q, q, off, None, scale=1.0,  # noqa: E731
                                              causal=True)
        else:
            x = torch.empty(1, 8, 2, 16, device="cuda")
            call = lambda: ssd.ssd_scan(x, torch.empty(1, 8, 2, device="cuda"),  # noqa: E731
                                        torch.empty(2, device="cuda"),
                                        torch.empty(1, 8, 1, 32, device="cuda"),
                                        torch.empty(1, 8, 1, 32, device="cuda"), 8)
        with pytest.raises(RuntimeError, match="fake tensor"):
            call()

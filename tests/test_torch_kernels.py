"""The port's kernels: plain versions against the reference's Pallas kernels
(interpret mode on the CPU), the CPU dispatch of the wrappers, and — on a
CUDA card only (``-m gpu``) — each CUDA kernel against its plain version
(the paged flash kernel's CPU parity is in ``test_torch_paged.py``, the
grouped GEMM's in ``test_torch_moe.py``, the SSD scan's in
``test_torch_ssm.py``).

Tolerances: fp32 2e-4 and bf16 3e-2 against the Pallas kernels (as
``test_kernels.py``); 2e-5 against the ragged-row oracle (as
``test_fused_step.py``); on the card fp32 1e-4 max abs, bf16 atol 1e-2 +
rtol 1e-2 (the two sides may round one fp32 value to neighbouring bf16
values, one bf16 ulp: 2^-8 relative), which also holds a plain model of
the bf16 chunk tile's arithmetic (P rounded to bf16 for P·V), and one of
the split-KV decode kernel's (fixed splits, per-warp online softmax, the
(m, l, O) merges), against the plain version on the CPU; the SSD scan on
the card as the
reference holds its Pallas kernel: max error over max |ref| under 1e-5 in
fp32 and 4e-2 in bf16, for y and the final state.  A plain model of the
bf16 SSD kernel's rounding (scores and W in bf16, the state as a hi + lo
bf16 pair) is held to the plain scan and the reference's ``ssd_chunked``
within that 4e-2 on the CPU, and the kernel to the model within 4e-3 on
the card.

The JAX reference is imported inside the tests that compare against it, so
the card tests run where only the port is installed:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py``.
"""

import dataclasses
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd


def _jax():
    import jax.numpy as jnp

    return jnp


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _both(a, dtype):
    """The same numpy data as a torch tensor and a JAX array of ``dtype``."""
    jnp = _jax()
    t = torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return t, jnp.asarray(t.float().numpy(), jdt)


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 256), (1, 300, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    from repro.kernels.rmsnorm.kernel import rmsnorm_pallas

    jnp = _jax()
    rng = np.random.default_rng(42)
    x, jx = _both(rng.standard_normal(shape), dtype)
    w = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    out = rn.rmsnorm_plain(x, torch.from_numpy(w))
    ref = rmsnorm_pallas(jx, jnp.asarray(w), interpret=True)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol
    )


def test_rmsnorm_wrapper_takes_plain_path_on_cpu():
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    w = torch.zeros(64)
    before = rn.launches
    assert torch.equal(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w))
    assert rn.launches == before


ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    """A script at the repository root as a module (``chip_smoke.py``'s
    phases run only when called; ``time_grouped_gemm.py`` imports torch
    alone)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# RMSNorm's main-path shapes, (rows, d, path), as chip_smoke.py checks and times them
RMS_SHAPES = _script("time_grouped_gemm").RMS_SHAPES


def _norm_widths(cfg):
    """The widths the model normalises: d_model, head_dim where q/k are
    normed per head, a Mamba layer's d_inner."""
    widths = {cfg.d_model}
    if cfg.qk_norm:
        widths.add(cfg.resolved_head_dim)
    if cfg.family in ("ssm", "hybrid"):
        widths.add(cfg.ssm_expand * cfg.d_model)
    return widths


@pytest.mark.parametrize("arch", ARCHS)
def test_rmsnorm_plan_puts_every_config_width_on_the_rows_kernel(arch):
    cfg = get_config(arch)
    for d in _norm_widths(cfg):
        for dtype in (torch.bfloat16, torch.float32):
            p = rn.plan(d, dtype)
            assert p.kernel == "rows", (arch, d, dtype)
            assert p.lanes * p.packs * 16 // torch.empty((), dtype=dtype).element_size() == d
            assert p.packs <= 10 and (p.lanes == 16 or p.lanes % 32 == 0)
            assert rn.plan(d, dtype, aligned=False).kernel == "generic"


@pytest.mark.parametrize("d", [1, 64, 100, 1000, 2047, 4096, 8192])
def test_rmsnorm_plan_sends_other_widths_to_the_generic_kernel(d):
    for dtype in (torch.bfloat16, torch.float32):
        p = rn.plan(d, dtype)
        assert p == rn.Plan("generic") and p.instance == "generic"
    assert rn.plan(2048, torch.float16).kernel == "generic"


def test_rmsnorm_instances_are_the_cuda_sources_table():
    """Every planned instance is built: ``ROWS_INSTANCES`` and the
    ``RMSNORM_ROWS_INSTANCES`` table of ``csrc/rmsnorm.cu`` are the same."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "rmsnorm.cu").read_text()
    table = src.split("#define RMSNORM_ROWS_INSTANCES(X)", 1)[1].split("\n\n", 1)[0]
    built = {(int(dt), int(lanes), int(packs))
             for dt, lanes, packs in re.findall(r"X\(\w+, (\d), (\d+), (\d+)\)", table)}
    planned = {(rn._DTYPES[dtype], lanes, packs)
               for dtype, by_width in rn.ROWS_INSTANCES.items()
               for lanes, packs in by_width.values()}
    assert built == planned and len(built) == 22


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(n, d) for n, d, _ in RMS_SHAPES]
                         + [(517, 2048), (20483, 128), (1, 5120), (1, 128)])
def test_rmsnorm_launch_shape(rows, d, dtype):
    """One row a block while the rows fit on the SMs one each (no SM holds
    two decode rows); else whole warps of at most 256 threads a block, the
    grid within the SMs' resident blocks and the rows spread evenly over
    the grid-stride loop."""
    sms = 132
    p = rn.plan(d, dtype)
    groups, grid = rn.launch_shape(p, rows, sms)
    threads = math.ceil(groups * p.lanes / 32) * 32
    assert threads <= rn.MAX_THREADS
    if rows <= sms:
        assert (groups, grid) == (1, rows)
        return
    assert groups == min(rn.MAX_THREADS // p.lanes, math.ceil(rows / sms))
    resident = sms * (rn.SM_THREADS // threads)
    assert grid <= resident
    # every row has a group, and no pass of the loop is wasted
    loops = math.ceil(rows / (grid * groups))
    assert loops == math.ceil(math.ceil(rows / groups) / resident)
    assert (grid - 1) * groups * loops < rows


@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma2-27b", "llama3.2-1b", "zamba2-2.7b",
                                  "qwen2-moe-a2.7b", "mamba2-130m", "gemma-7b"])
def test_norms_per_forward_counts_the_wrappers_calls(arch, monkeypatch):
    """``chip_smoke.norms_per_forward`` is what one forward calls the
    RMSNorm wrapper: a ``.smoke()`` fused step through the kernel path."""
    from repro_torch.models.model import build_model

    cs = _script("chip_smoke")
    calls = []
    plain = rn.rmsnorm

    def counted(x, w, eps=1e-6):
        calls.append(tuple(x.shape))
        return plain(x, w, eps)

    monkeypatch.setattr(rn, "rmsnorm", counted)
    cfg = dataclasses.replace(get_config(arch).smoke(), attention_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    caches = model.init_cache(2, 16, "cpu")
    toks = torch.ones((2, 4), dtype=torch.int32)
    logits, _ = model.fused_step(params, {"tokens": toks}, caches, np.array([0, 3]),
                                 np.array([4, 2]))
    assert torch.isfinite(logits).all()
    assert len(calls) == cs.norms_per_forward(cfg) > 0
    # and at full width the count the card run holds each forward to
    full = {"qwen3-14b": 161, "gemma2-27b": 185, "llama3.2-1b": 33, "zamba2-2.7b": 127,
            "qwen2-moe-a2.7b": 49, "mamba2-130m": 49, "gemma-7b": 57}
    assert cs.norms_per_forward(get_config(arch)) == full[arch]


# --------------------------------------------------------------- flash attn
# the cases of test_kernels.py::test_flash_attention_kernel
CASES = [
    # b, sq, sk, h, kv, d, window, cap
    (2, 128, 128, 4, 2, 64, 0, 0.0),
    (1, 256, 256, 8, 8, 128, 64, 50.0),   # window + softcap (gemma2)
    (2, 96, 96, 4, 1, 80, 0, 0.0),        # MQA + unaligned dims
    (1, 128, 384, 2, 2, 64, 0, 0.0),      # long KV (q_offset)
    (1, 64, 192, 4, 4, 256, 0, 0.0),      # gemma-7b's head dim, MHA, q_offset
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_matches_pallas(case, dtype):
    from repro.kernels.flash_attention.ops import flash_attention as j_flash

    b, sq, sk, h, kv, d, window, cap = case
    rng = np.random.default_rng(42)
    q, jq = _both(rng.standard_normal((b, sq, h, d)), dtype)
    k, jk = _both(rng.standard_normal((b, sk, kv, d)), dtype)
    v, jv = _both(rng.standard_normal((b, sk, kv, d)), dtype)
    scale = 1.0 / np.sqrt(d)
    qo = sk - sq
    out = fa.flash_attention_plain(
        q, k, v, torch.full((b,), qo, dtype=torch.int32),
        torch.full((b,), sq, dtype=torch.int32),
        scale=scale, causal=True, window=window or None, softcap=cap or None,
    )
    ref = j_flash(
        jq, jk, jv, scale=scale, causal=True, window=window or None,
        softcap=cap or None, q_offset=qo, interpret=True,
    )
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol
    )


# the mixed fused rows of test_fused_step.py: full chunk at 0, decode row
# deep in the cache, partial tail chunk at an offset, idle row
_ROWS = [(0, 8), (19, 1), (13, 5), (0, 0)]


def _ragged_inputs(rng, rows, sq, sk, h, kv, d):
    b = len(rows)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    cache_pos = np.asarray([r[0] for r in rows], np.int32)
    q_lens = np.asarray([r[1] for r in rows], np.int32)
    return q, k, v, cache_pos, q_lens


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 30.0)])
def test_flash_plain_matches_pallas_fused_rows(window, softcap):
    from repro.kernels.flash_attention.ops import flash_attention as j_flash

    jnp = _jax()
    rng = np.random.default_rng(11)
    sq = 8
    q, k, v, cache_pos, q_lens = _ragged_inputs(rng, _ROWS, sq, 24, 4, 2, 64)
    scale = 1.0 / np.sqrt(64)
    q_pos = cache_pos[:, None] + np.arange(sq, dtype=np.int32)[None]
    ref = j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos), None,
        jnp.asarray(q_lens), scale=scale, causal=True, window=window or None,
        softcap=softcap or None, interpret=True,
    )
    out = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(cache_pos), torch.from_numpy(q_lens),
        scale=scale, causal=True, window=window or None, softcap=softcap or None,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    for bi, (_, n) in enumerate(_ROWS):
        assert not out[bi, n:].any(), f"row {bi} padding queries leaked"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flash_plain_matches_pallas_random_rows(seed):
    """Random (cache_pos, q_len) compositions, as the property test of
    ``test_fused_step.py`` draws them."""
    from repro.kernels.flash_attention.ops import flash_attention as j_flash

    jnp = _jax()
    rng = np.random.default_rng(seed)
    sq = int(rng.integers(1, 13))
    window = int(rng.integers(0, 10))
    b, sk, h, kv, d = 3, 32, 2, 1, 64
    q_lens = rng.integers(0, sq + 1, size=b).astype(np.int32)
    rows = [(int(rng.integers(0, sk - int(n) + 1)), int(n)) for n in q_lens]
    q, k, v, cache_pos, q_lens = _ragged_inputs(rng, rows, sq, sk, h, kv, d)
    scale = 1.0 / np.sqrt(d)
    q_pos = cache_pos[:, None] + np.arange(sq, dtype=np.int32)[None]
    ref = j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos), None,
        jnp.asarray(q_lens), scale=scale, causal=True, window=window or None,
        interpret=True,
    )
    out = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(cache_pos), torch.from_numpy(q_lens),
        scale=scale, causal=True, window=window or None,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_flash_wrapper_takes_plain_path_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v, cache_pos, q_lens = _ragged_inputs(rng, _ROWS, 8, 24, 4, 2, 32)
    args = [torch.from_numpy(a) for a in (q, k, v, cache_pos, q_lens)]
    before = fa.launches
    out = fa.flash_attention(*args, scale=0.2, causal=True)
    assert torch.equal(out, fa.flash_attention_plain(*args, scale=0.2, causal=True))
    assert fa.launches == before


# ------------------------------------------------------- on the card (-m gpu)
# the masks off, and gemma2's window 64 + softcap 50
_WINDOW_SOFTCAP = [(None, None), (64, 50.0)]


def _assert_within(out, ref):
    atol, rtol = (1e-4, 0.0) if out.dtype == torch.float32 else (1e-2, 1e-2)
    excess = ((out.float() - ref.float()).abs() - rtol * ref.float().abs()).max().item()
    assert excess <= atol, excess


def _card_flash_case(device, dtype, *, sq, sk, b, depths, q_lens, window=None, softcap=None,
                     h=32, kv=8, d=64, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g, device=device).to(dtype)
    k = torch.randn(b, sk, kv, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, sk, kv, d, generator=g, device=device).to(dtype)
    offs = torch.tensor(depths, dtype=torch.int32, device=device)
    lens = torch.tensor(q_lens, dtype=torch.int32, device=device)
    kw = dict(scale=d ** -0.5, causal=True, window=window, softcap=softcap)
    out = fa.flash_attention(q, k, v, offs, lens, **kw)
    ref = fa.flash_attention_plain(q, k, v, offs, lens, **kw)
    torch.cuda.synchronize(device)
    _assert_within(out, ref)
    for bi, n in enumerate(q_lens):
        assert not out[bi, n:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_decode_rows_on_card(cuda_device, dtype):
    depths = [0, 5, 63, 64, 700, 1500, 2000, 2047]
    _card_flash_case(cuda_device, dtype, sq=1, sk=2048, b=8, depths=depths,
                     q_lens=[1] * 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (64, 50.0)])
def test_flash_kernel_fused_chunk_on_card(cuda_device, dtype, window, softcap):
    depths = [0, 100, 1984, 7, 300, 0, 1000, 2047]
    q_lens = [64, 1, 64, 0, 17, 0, 64, 1]
    _card_flash_case(cuda_device, dtype, sq=64, sk=2048, b=8, depths=depths,
                     q_lens=q_lens, window=window, softcap=softcap)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 48, 64, 80, 128, 256])
def test_flash_kernel_head_dims_on_card(cuda_device, d):
    """The kernel is built for head dims 32, 64, 80, 128 and 256; the
    wrapper refuses the others."""
    if d not in (32, 64, 80, 128, 256):
        with pytest.raises(ValueError, match="head_dim"):
            _card_flash_case(cuda_device, torch.float32, sq=5, sk=200, b=2, depths=[0, 150],
                             q_lens=[5, 3], h=4, kv=2, d=d)
        return
    _card_flash_case(cuda_device, torch.float32, sq=5, sk=200, b=2, depths=[0, 150],
                     q_lens=[5, 3], h=4, kv=2, d=d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(512, 2048), (3, 7, 64)])
def test_rmsnorm_kernel_on_card(cuda_device, dtype, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda_device) * 0.1
    out = rn.rmsnorm(x, w)
    ref = rn.rmsnorm_plain(x, w)
    torch.cuda.synchronize(cuda_device)
    _assert_within(out, ref)


def _card_rms_case(x, w, kernel):
    """The kernel ``kernel`` ran once a call, within tolerance of the plain
    version, and two launches are bit-identical."""
    before = (rn.launches, rn.rows_launches, rn.generic_launches)
    out, again = rn.rmsnorm(x, w), rn.rmsnorm(x, w)
    ref = rn.rmsnorm_plain(x, w)
    torch.cuda.synchronize(x.device)
    ran = (rn.launches - before[0], rn.rows_launches - before[1],
           rn.generic_launches - before[2])
    assert ran == ((2, 2, 0) if kernel == "rows" else (2, 0, 2))
    _assert_within(out, ref)
    assert torch.equal(out, again)


def _card_rms_inputs(device, dtype, rows, d):
    g = torch.Generator(device=device).manual_seed(rows * 7 + d)
    return (torch.randn(rows, d, generator=g, device=device).to(dtype),
            torch.randn(d, generator=g, device=device) * 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(n, d) for n, d, _ in RMS_SHAPES]
                         + [(517, 2048), (20483, 128), (129, 768), (3, 4608), (1, 5120),
                            (1, 128)])
def test_rmsnorm_rows_kernel_on_card(cuda_device, dtype, rows, d):
    """Every main-path shape, row counts that leave a block's last row
    groups idle, and one row: on the rows kernel."""
    x, w = _card_rms_inputs(cuda_device, dtype, rows, d)
    _card_rms_case(x, w, "rows")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["d100", "d1000", "x_misaligned", "w_misaligned"])
def test_rmsnorm_generic_kernel_on_card(cuda_device, dtype, case):
    """Widths no instance covers (element loads at 100, 16-byte loads at
    1000) and a misaligned x or w: on the generic kernel."""
    d = {"d100": 100, "d1000": 1000}.get(case, 2048)
    x, w = _card_rms_inputs(cuda_device, dtype, 65, d)
    if case == "x_misaligned":
        x = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)[1:].view_as(x).copy_(x)
    if case == "w_misaligned":
        w = torch.empty(d + 1, device=cuda_device)[1:].copy_(w)
    _card_rms_case(x, w, "generic")


@pytest.mark.gpu
def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda_device):
    x = torch.randn(4, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        rn.rmsnorm(x, torch.zeros(64, device=cuda_device))
    q = torch.randn(1, 2, 4, 48, device=cuda_device)
    kv = torch.randn(1, 8, 2, 48, device=cuda_device)
    offs = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv, offs, scale=1.0)
    # q copied in 16-byte pieces: a contiguous view 4 bytes off is refused
    q = torch.randn(1 * 2 * 4 * 64 + 1, device=cuda_device)[1:].view(1, 2, 4, 64)
    kv = torch.randn(1, 8, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="align"):
        fa.flash_attention(q, kv, kv, offs, scale=1.0)


def _card_paged_case(device, dtype, *, P, depths, q_lens, sq, max_len=2048, h=32, kv=8,
                     d=64, shared=2, seed=0):
    """Pools and a page table as the engine builds them: every page a row's
    visible keys need is mapped (rows 0 and 1 share their first ``shared``
    pages), the rest ``-1``; the trash page holds large finite garbage."""
    rng = np.random.default_rng(seed)
    b = len(depths)
    pps = -(-max_len // P)
    need = [-(-(dp + n) // P) for dp, n in zip(depths, q_lens)]
    num_pages = sum(need) + 3
    ids = iter(rng.permutation(num_pages).tolist())
    table = np.full((b, pps), -1, np.int32)
    for bi, n in enumerate(need):
        for j in range(n):
            table[bi, j] = table[0, j] if bi == 1 and j < shared and table[0, j] >= 0 else next(ids)
    g = torch.Generator(device=device).manual_seed(seed)
    pool_k = torch.randn(num_pages + 1, P, kv, d, generator=g, device=device).to(dtype)
    pool_v = torch.randn(num_pages + 1, P, kv, d, generator=g, device=device).to(dtype)
    pool_k[-1] = 1e4
    pool_v[-1] = -1e4
    q = torch.randn(b, sq, h, d, generator=g, device=device).to(dtype)
    return (q, pool_k, pool_v, torch.from_numpy(table).to(device),
            torch.tensor(depths, dtype=torch.int32, device=device),
            torch.tensor(q_lens, dtype=torch.int32, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [16, 64, 48])
@pytest.mark.parametrize("window,softcap", [(None, None), (64, 50.0)])
def test_flash_paged_kernel_on_card(cuda_device, dtype, P, window, softcap):
    """The paged kernel against its plain version and against the dense
    kernel on the gathered view, with shared pages, unmapped entries, a
    garbage trash page and q_lens 0/1/17/64 at random depths (P = 48 does
    not divide the kernel's 64-key tile)."""
    q_lens = [64, 1, 0, 17, 64, 1, 17, 0]
    rng = np.random.default_rng(P)
    depths = [int(rng.integers(0, 2048 - n + 1)) for n in q_lens]
    depths[1] = depths[0] + 64                     # row 1 reads row 0's shared pages
    q, pk, pv, table, offs, lens = _card_paged_case(
        cuda_device, dtype, P=P, depths=depths, q_lens=q_lens, sq=64)
    kw = dict(scale=0.125, causal=True, window=window, softcap=softcap)
    before = fa.paged_launches
    out = fa.flash_attention_paged(q, pk, pv, table, offs, lens, **kw)
    assert fa.paged_launches == before + 1
    ref = fa.flash_attention_paged_plain(q, pk, pv, table, offs, lens, **kw)
    k, v = fa.paged_view(pk, table), fa.paged_view(pv, table)
    dense = fa.flash_attention(q, k.contiguous(), v.contiguous(), offs, lens, **kw)
    pk[-1] = 0
    pv[-1] = 0
    clean = fa.flash_attention_paged(q, pk, pv, table, offs, lens, **kw)
    torch.cuda.synchronize(cuda_device)
    _assert_within(out, ref)
    assert torch.equal(out, dense)       # one function, one order of sums
    assert torch.equal(out, clean)       # the trash page is never read
    for bi, n in enumerate(q_lens):
        assert not out[bi, n:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_paged_kernel_decode_rows_on_card(cuda_device, dtype):
    depths = [0, 5, 63, 64, 700, 1500, 2000, 2047]
    q, pk, pv, table, offs, lens = _card_paged_case(
        cuda_device, dtype, P=64, depths=depths, q_lens=[1] * 8, sq=1)
    out = fa.flash_attention_paged(q, pk, pv, table, offs, lens, scale=0.125)
    ref = fa.flash_attention_paged_plain(q, pk, pv, table, offs, lens, scale=0.125)
    torch.cuda.synchronize(cuda_device)
    _assert_within(out, ref)


@pytest.mark.gpu
def test_paged_wrapper_raises_on_inputs_the_kernel_does_not_take(cuda_device):
    q, pk, pv, table, offs, lens = _card_paged_case(
        cuda_device, torch.float32, P=16, depths=[0, 16], q_lens=[5, 1], sq=5, h=4, kv=2)
    with pytest.raises(TypeError):
        fa.flash_attention_paged(q, pk.to(torch.bfloat16), pv, table, offs, lens, scale=1.0)
    with pytest.raises(ValueError):
        fa.flash_attention_paged(q, pk, pv, table[:1], offs, lens, scale=1.0)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_paged(q[..., :48].contiguous(), pk[..., :48].contiguous(),
                                 pv[..., :48].contiguous(), table, offs, lens, scale=1.0)
    with pytest.raises(TypeError):
        fa.flash_attention_paged(q, pk, pv, table, offs.long(), lens, scale=1.0)
    # head dim 128 runs (qwen2-moe-a2.7b)
    q, pk, pv, table, offs, lens = _card_paged_case(
        cuda_device, torch.float32, P=16, depths=[0, 16], q_lens=[5, 1], sq=5, h=4, kv=2, d=128)
    out = fa.flash_attention_paged(q, pk, pv, table, offs, lens, scale=1.0)
    ref = fa.flash_attention_paged_plain(q, pk, pv, table, offs, lens, scale=1.0)
    torch.cuda.synchronize(cuda_device)
    _assert_within(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("sq", [1, 64], ids=["decode", "fused_chunk"])
def test_flash_kernels_head_dim_128_without_gqa_on_card(cuda_device, dtype, paged, sq):
    """qwen2-moe-a2.7b's attention: head dim 128, 16 query and 16 KV heads
    (rep = 1), decode rows and fused chunks at random depths."""
    q_lens = [1] * 8 if sq == 1 else [64, 1, 0, 17, 64, 1, 17, 0]
    rng = np.random.default_rng(sq)
    depths = [int(rng.integers(0, 2048 - n + 1)) for n in q_lens]
    if not paged:
        _card_flash_case(cuda_device, dtype, sq=sq, sk=2048, b=8, depths=depths,
                         q_lens=q_lens, h=16, kv=16, d=128)
        return
    q, pk, pv, table, offs, lens = _card_paged_case(
        cuda_device, dtype, P=64, depths=depths, q_lens=q_lens, sq=sq, h=16, kv=16, d=128)
    out = fa.flash_attention_paged(q, pk, pv, table, offs, lens, scale=128 ** -0.5)
    ref = fa.flash_attention_paged_plain(q, pk, pv, table, offs, lens, scale=128 ** -0.5)
    torch.cuda.synchronize(cuda_device)
    _assert_within(out, ref)
    for bi, n in enumerate(q_lens):
        assert not out[bi, n:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("sq", [1, 64], ids=["decode", "fused_chunk"])
def test_flash_kernels_head_dim_80_on_card(cuda_device, dtype, paged, sq):
    """zamba2-2.7b's shared attention: head dim 80, 32 query and 32 KV
    heads, decode rows (the split-KV decode kernel) and fused chunks; every
    output dim, 64-79 included, is held to the plain version."""
    q_lens = [1] * 8 if sq == 1 else [64, 1, 0, 17, 64, 1, 17, 0]
    rng = np.random.default_rng(80 + sq)
    depths = [int(rng.integers(0, 2048 - n + 1)) for n in q_lens]
    if not paged:
        _card_flash_case(cuda_device, dtype, sq=sq, sk=2048, b=8, depths=depths,
                         q_lens=q_lens, h=32, kv=32, d=80)
        return
    q, pk, pv, table, offs, lens = _card_paged_case(
        cuda_device, dtype, P=64, depths=depths, q_lens=q_lens, sq=sq, h=32, kv=32, d=80)
    out = fa.flash_attention_paged(q, pk, pv, table, offs, lens, scale=80 ** -0.5)
    ref = fa.flash_attention_paged_plain(q, pk, pv, table, offs, lens, scale=80 ** -0.5)
    dense = fa.flash_attention(q, fa.paged_view(pk, table).contiguous(),
                               fa.paged_view(pv, table).contiguous(), offs, lens,
                               scale=80 ** -0.5)
    torch.cuda.synchronize(cuda_device)
    _assert_within(out, ref)
    assert torch.equal(out, dense)
    for bi, n in enumerate(q_lens):
        assert not out[bi, n:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("sq", [1, 64], ids=["decode", "fused_chunk"])
@pytest.mark.parametrize("window,softcap", _WINDOW_SOFTCAP, ids=["plain", "window_softcap"])
def test_flash_kernels_head_dim_256_on_card(cuda_device, dtype, paged, sq, window, softcap):
    """gemma-7b's attention: head dim 256, 16 query and 16 KV heads,
    decode rows (the split-KV decode kernel) and fused chunks (the fp32
    tile's 32-key tiles, the bf16 tile's Q fragments read from shared
    memory); paged also bit-equal to the dense kernel on the gathered
    view."""
    q_lens = [1] * 8 if sq == 1 else [64, 1, 0, 17, 64, 1, 17, 0]
    rng = np.random.default_rng(256 + sq)
    depths = [int(rng.integers(0, 2048 - n + 1)) for n in q_lens]
    kw = dict(scale=256 ** -0.5, causal=True, window=window, softcap=softcap)
    if not paged:
        _card_flash_case(cuda_device, dtype, sq=sq, sk=2048, b=8, depths=depths,
                         q_lens=q_lens, window=window, softcap=softcap, h=16, kv=16, d=256)
        return
    q, pk, pv, table, offs, lens = _card_paged_case(
        cuda_device, dtype, P=64, depths=depths, q_lens=q_lens, sq=sq, h=16, kv=16, d=256)
    out = fa.flash_attention_paged(q, pk, pv, table, offs, lens, **kw)
    ref = fa.flash_attention_paged_plain(q, pk, pv, table, offs, lens, **kw)
    dense = fa.flash_attention(q, fa.paged_view(pk, table).contiguous(),
                               fa.paged_view(pv, table).contiguous(), offs, lens, **kw)
    torch.cuda.synchronize(cuda_device)
    _assert_within(out, ref)
    assert torch.equal(out, dense)
    for bi, n in enumerate(q_lens):
        assert not out[bi, n:].any()



# ------------------------------------------ the bf16 chunk tile (mma.sync)
# attention heads (query, KV) and head dim of each served model
_MODEL_HEADS = {"llama3.2-1b": (32, 8, 64), "zamba2-2.7b": (32, 32, 80),
                "qwen2-moe-a2.7b": (16, 16, 128), "gemma-7b": (16, 16, 256),
                "gemma2-27b": (32, 16, 128)}


def _chunk_tile_model(q, k, v, q_offsets, q_lens, *, scale, window=None, softcap=None, bk=64):
    """The arithmetic of the bf16 chunk tile in plain PyTorch: bf16 q/k/v,
    fp32 scores, an online softmax over ``bk``-key tiles with a running max,
    P rounded to bf16 for P·V only, fp32 l and O, output in bf16."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kv, h // kv, d)
    kf, vf = k.float(), v.float()
    vis_all = fa.visible_mask(q_offsets, q_lens, sq, sk, causal=True, window=window)
    m = torch.full((b, kv, h // kv, sq), -1e30)
    l = torch.zeros(b, kv, h // kv, sq)
    o = torch.zeros(b, kv, h // kv, sq, d)
    for kt in range(0, sk, bk):
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kf[:, kt:kt + bk]) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        vis = vis_all[:, None, None, :, kt:kt + bk]
        s = torch.where(vis, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(torch.bfloat16).float(), vf[:, kt:kt + bk])
        o = o * alpha[..., None] + pv
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(torch.bfloat16)


@pytest.mark.parametrize("window,softcap", _WINDOW_SOFTCAP, ids=["plain", "window_softcap"])
@pytest.mark.parametrize("model", list(_MODEL_HEADS))
def test_chunk_tile_rounding_of_p_within_bf16_tolerance(model, window, softcap):
    """Rounding P to bf16 for P·V (the tensor-core chunk tile) stays within
    the card's bf16 tolerance of the plain version, which keeps P in fp32:
    at chip_smoke.py's timed chunk shape (8 rows x 64 queries, q_lens
    64/1/0/64/17/1/64/0 at random depths, 2048 keys) of each model's heads."""
    h, kv, d = _MODEL_HEADS[model]
    rng = np.random.default_rng(0)
    rng.integers(0, 2048, size=8)                 # the decode depths chip_smoke.py draws first
    q_lens = [64, 1, 0, 64, 17, 1, 64, 0]
    depths = [int(rng.integers(0, 2048 - n + 1)) for n in q_lens]
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((8, 64, h, d), (8, 2048, kv, d), (8, 2048, kv, d)))
    offs = torch.tensor(depths, dtype=torch.int32)
    lens = torch.tensor(q_lens, dtype=torch.int32)
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap)
    out = _chunk_tile_model(q, k, v, offs, lens, **kw)
    ref = fa.flash_attention_plain(q, k, v, offs, lens, causal=True, **kw)
    _assert_within(out, ref)
    assert not torch.equal(out, ref)              # the rounding is really modelled
    for bi, n in enumerate(q_lens):
        assert not out[bi, n:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", _WINDOW_SOFTCAP, ids=["plain", "window_softcap"])
@pytest.mark.parametrize("sq", [17, 64, 100, 300])
@pytest.mark.parametrize("kv_layout", ["dense", "P16", "P48", "P64"])
@pytest.mark.parametrize("model", list(_MODEL_HEADS))
def test_flash_chunk_tile_on_card(cuda_device, model, kv_layout, sq, window, softcap):
    """The tensor-core chunk tile (bf16, Sq·rep > 16) against the plain
    version at each model's heads: a row at depth 0, a row whose last key
    (1001 + Sq) is not a multiple of the 64-key tile, rows of q_len 1 and 5
    (whole warps of their row tile idle) and an idle row; paged also
    bit-equal to the dense kernel on the gathered view, with a garbage
    trash page."""
    h, kv, d = _MODEL_HEADS[model]
    depths, q_lens = [0, 1001, 517, 300, 1703], [sq, sq, 1, 5, 0]
    kw = dict(scale=d ** -0.5, causal=True, window=window, softcap=softcap)
    if kv_layout == "dense":
        _card_flash_case(cuda_device, torch.bfloat16, sq=sq, sk=2048, b=5, depths=depths,
                         q_lens=q_lens, window=window, softcap=softcap, h=h, kv=kv, d=d)
        return
    q, pk, pv, table, offs, lens = _card_paged_case(
        cuda_device, torch.bfloat16, P=int(kv_layout[1:]), depths=depths, q_lens=q_lens, sq=sq,
        h=h, kv=kv, d=d)
    out = fa.flash_attention_paged(q, pk, pv, table, offs, lens, **kw)
    ref = fa.flash_attention_paged_plain(q, pk, pv, table, offs, lens, **kw)
    dense = fa.flash_attention(q, fa.paged_view(pk, table).contiguous(),
                               fa.paged_view(pv, table).contiguous(), offs, lens, **kw)
    torch.cuda.synchronize(cuda_device)
    _assert_within(out, ref)
    assert torch.equal(out, dense)
    for bi, n in enumerate(q_lens):
        assert not out[bi, n:].any()

# ------------------------------------------------- the split-KV decode kernel
_NEG = -1e30
_LOG2E = 1.4426950408889634


def _merge_partials(parts):
    """Merge (m, l, O) partial softmaxes (m in log2 units) in list order, as
    the decode kernel merges its warps and then its splits: weights
    2^(m - M), a partial that saw no key (m = NEG) contributing exactly 0."""
    big_m = parts[0][0]
    for m, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m)
    m_sub = torch.where(big_m == _NEG, torch.zeros_like(big_m), big_m)
    l_sum = torch.zeros_like(big_m)
    acc = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        a = torch.exp2(m - m_sub)
        l_sum = l_sum + a * l
        acc = acc + a[..., None] * o
    return big_m, l_sum, acc


def _decode_split_model(q, k, v, q_offsets, q_lens, *, scale, window=None, softcap=None,
                        split=256, bk=64, warps=4):
    """The arithmetic of the split-KV decode kernel in plain PyTorch, fp32:
    the key axis cut at absolute multiples of ``split``; in each split,
    ``warps`` online softmaxes (log2 units), each over its ``bk / warps``
    keys of every ``bk``-key tile; the warps' (m, l, O) merged in order,
    then the splits'; P kept in fp32; rows past q_len (or with no visible
    key) exact zeros."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    rows = sq * rep
    qf = q.float().reshape(b, sq, kv, rep, d).permute(0, 2, 1, 3, 4).reshape(b, kv, rows, d)
    kf, vf = k.float(), v.float()
    vis = fa.visible_mask(q_offsets, q_lens, sq, sk, causal=True, window=window)
    vis = vis[:, None, :, None, :].expand(b, kv, sq, rep, sk).reshape(b, kv, rows, sk)
    kw = bk // warps
    splits = []
    for s0 in range(0, sk, split):
        state = [(torch.full((b, kv, rows), _NEG), torch.zeros(b, kv, rows),
                  torch.zeros(b, kv, rows, d)) for _ in range(warps)]
        for kt in range(s0, min(s0 + split, sk), bk):
            for w in range(warps):
                keys = slice(kt + w * kw, min(kt + (w + 1) * kw, sk))
                if keys.start >= sk:
                    continue
                x = torch.einsum("bgrd,bkgd->bgrk", qf, kf[:, keys])
                x = (softcap * _LOG2E * torch.tanh(x * (scale / softcap)) if softcap
                     else x * (scale * _LOG2E))
                x = torch.where(vis[..., keys], x, torch.full_like(x, _NEG))
                m, l, o = state[w]
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - m_new)
                m_sub = torch.where(m_new == _NEG, torch.zeros_like(m_new), m_new)
                p = torch.exp2(x - m_sub[..., None])
                state[w] = (m_new, l * alpha + p.sum(-1),
                            o * alpha[..., None] + torch.einsum("bgrk,bkgd->bgrd", p, vf[:, keys]))
        splits.append(_merge_partials(state))
    _, l, o = _merge_partials(splits)
    out = o / l.clamp_min(1e-30)[..., None]
    qi = torch.arange(rows) // rep
    valid = qi[None, :] < q_lens.long()[:, None]                       # [b, rows]
    out = torch.where(valid[:, None, :, None], out, torch.zeros_like(out))
    return out.reshape(b, kv, sq, rep, d).permute(0, 2, 1, 3, 4).reshape(b, sq, h, d).to(q.dtype)


def _decode_depths(dtype, d):
    """Depths around the first split boundary, the cache's ends, and an
    idle row (q_len 0)."""
    split = fa._decode_split(dtype, d)
    return [split - 1, split, split + 1, 0, 2047, 1000], [1, 1, 1, 1, 1, 0]


def _attention_ref_rows(q, k, v, depths, q_lens, *, scale, window, softcap):
    """The JAX oracle (``kernels/flash_attention/ref.py``) row by row at
    each row's depth, GQA folded as the reference wrapper folds it; rows
    past q_len are the kernel contract's zeros."""
    from repro.kernels.flash_attention.ref import attention_ref

    jnp = _jax()
    b, sq, h, d = q.shape
    rep = h // k.shape[2]
    jdt = jnp.float32 if q.dtype == torch.float32 else jnp.bfloat16
    out = np.zeros((b, sq, h, d), np.float32)
    for bi, (dp, n) in enumerate(zip(depths, q_lens)):
        if n == 0:
            continue
        qb = jnp.asarray(q[bi].float().numpy(), jdt).transpose(1, 0, 2)            # [h, sq, d]
        kb = jnp.repeat(jnp.asarray(k[bi].float().numpy(), jdt).transpose(1, 0, 2), rep, axis=0)
        vb = jnp.repeat(jnp.asarray(v[bi].float().numpy(), jdt).transpose(1, 0, 2), rep, axis=0)
        ob = attention_ref(qb, kb, vb, scale=scale, causal=True, window=window or 0,
                           softcap=softcap or 0.0, q_offset=dp)
        out[bi, :n] = np.asarray(ob, np.float32).transpose(1, 0, 2)[:n]
    return out


def _decode_inputs(rng, dtype, b, sq, sk, h, kv, d):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


@pytest.mark.parametrize("window,softcap", _WINDOW_SOFTCAP, ids=["plain", "window_softcap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", list(_MODEL_HEADS))
def test_decode_split_model_matches_reference(model, dtype, window, softcap):
    """A plain model of the decode kernel's split arithmetic (fixed splits,
    per-warp online softmax in 64-key tiles, the (m, l, O) merges) against
    the JAX oracle (2e-4 fp32, 3e-2 bf16, as the Pallas comparisons) and
    against ``flash_attention_plain`` (the card tolerance), at each model's
    heads, depths split-1 / split / split+1 / 0 / 2047 and an idle row; and
    its result does not change when the key axis grows (2048 to 2112 keys,
    garbage past every row): the split boundaries are absolute, which is
    what keeps the paged kernel bit-equal to the dense one."""
    h, kv, d = _MODEL_HEADS[model]
    depths, q_lens = _decode_depths(dtype, d)
    rng = np.random.default_rng(7)
    q, k, v = _decode_inputs(rng, dtype, len(depths), 1, 2112, h, kv, d)
    k[:, 2048:] = 1e4
    v[:, 2048:] = -1e4
    offs = torch.tensor(depths, dtype=torch.int32)
    lens = torch.tensor(q_lens, dtype=torch.int32)
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap)
    split = fa._decode_split(dtype, d)
    out = _decode_split_model(q, k[:, :2048], v[:, :2048], offs, lens, split=split, **kw)
    grown = _decode_split_model(q, k, v, offs, lens, split=split, **kw)
    assert torch.equal(out, grown)
    _assert_within(out, fa.flash_attention_plain(q, k[:, :2048], v[:, :2048], offs, lens,
                                                 causal=True, **kw))
    ref = _attention_ref_rows(q, k[:, :2048], v[:, :2048], depths, q_lens, **kw)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol)
    assert not out[q_lens.index(0)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_model_short_queries(dtype):
    """Sq > 1 with few heads (4 queries × llama's rep 4 = 16 rows, the most
    a decode block holds), rows past q_len zero, against the plain version
    and the JAX oracle."""
    rng = np.random.default_rng(8)
    depths, q_lens = [0, 300, 1800, 40], [4, 2, 4, 0]
    q, k, v = _decode_inputs(rng, dtype, 4, 4, 2048, 32, 8, 64)
    offs = torch.tensor(depths, dtype=torch.int32)
    lens = torch.tensor(q_lens, dtype=torch.int32)
    kw = dict(scale=0.125, window=None, softcap=None)
    out = _decode_split_model(q, k, v, offs, lens, split=fa._decode_split(dtype, 64), **kw)
    _assert_within(out, fa.flash_attention_plain(q, k, v, offs, lens, causal=True, **kw))
    ref = _attention_ref_rows(q, k, v, depths, q_lens, **kw)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol)
    for bi, n in enumerate(q_lens):
        assert not out[bi, n:].any()


def test_decode_workspace_sizes():
    """The wrapper's scratch for the decode kernel: (D + 2) fp32 per row and
    split (256 keys where a K row is at most 128 bytes, 128 where it is at
    most 512, else 64), only for calls of at most 16 rows (8 at head dim
    256) whose keys span several splits."""
    q = torch.zeros(8, 1, 32, 64, dtype=torch.bfloat16)
    ws = fa._decode_workspace(q, 8, 2048)
    assert ws.dtype == torch.float32 and ws.numel() == 8 * 8 * (2048 // 256) * 4 * 66
    assert fa._decode_workspace(q.float(), 8, 2048).numel() == 8 * 8 * (2048 // 128) * 4 * 66
    q128 = torch.zeros(8, 1, 16, 128, dtype=torch.bfloat16)          # 256-byte rows: 128 keys
    assert fa._decode_workspace(q128, 16, 2048).numel() == 8 * 16 * (2048 // 128) * 1 * 130
    assert fa._decode_workspace(q, 8, 256) is None                    # one split
    assert fa._decode_workspace(torch.zeros(8, 5, 32, 64), 8, 2048) is None   # 20 rows: a chunk
    # head dim 256 (gemma-7b): 512-byte bf16 rows, 128 keys; 1024-byte fp32 rows, 64 keys
    q256 = torch.zeros(8, 1, 16, 256, dtype=torch.bfloat16)
    assert fa._decode_split(torch.bfloat16, 256) == 128
    assert fa._decode_split(torch.float32, 256) == 64
    assert fa._decode_workspace(q256, 16, 2048).numel() == 8 * 16 * (2048 // 128) * 1 * 258
    assert fa._decode_workspace(q256.float(), 16, 2048).numel() == 8 * 16 * (2048 // 64) * 1 * 258
    assert fa._decode_workspace(q256.float(), 16, 64) is None         # one 64-key split
    # at most 8 rows a KV head: 8 queries run the decode kernel, 9 a chunk tile
    assert fa._decode_rows(256) == 8 and fa._decode_rows(128) == 16
    assert fa._decode_workspace(torch.zeros(2, 8, 16, 256), 16, 2048).numel() == (
        2 * 16 * (2048 // 64) * 8 * 258)
    assert fa._decode_workspace(torch.zeros(2, 9, 16, 256), 16, 2048) is None


def _card_paged_from_dense(k, v, P, table_rng, depths, q_lens):
    """Pools holding dense k/v's rows in pages of P tokens, in a random
    order, every page a row's visible keys need mapped and the rest -1; the
    trash page holds large finite garbage."""
    b, sk, kv, d = k.shape
    pps = -(-sk // P)
    need = [-(-(dp + n) // P) for dp, n in zip(depths, q_lens)]
    num = sum(need) + 3
    ids = iter(table_rng.permutation(num).tolist())
    table = torch.full((b, pps), -1, dtype=torch.int32)
    pk = torch.zeros(num + 1, P, kv, d, dtype=k.dtype, device=k.device)
    pv = torch.zeros_like(pk)
    for bi, n in enumerate(need):
        for j in range(n):
            pg = next(ids)
            table[bi, j] = pg
            rows = min(P, sk - j * P)
            pk[pg, :rows] = k[bi, j * P:j * P + rows]
            pv[pg, :rows] = v[bi, j * P:j * P + rows]
    pk[-1] = 1e4
    pv[-1] = -1e4
    return pk, pv, table.to(k.device)


def _card_decode_case(device, dtype, *, h, kv, d, sq, depths, q_lens, kv_layout, window=None,
                      softcap=None, seed=0):
    """The decode kernel against the plain version; twice, bit-identical;
    paged also bit-equal to the dense kernel on the gathered view, and with
    the trash page zeroed instead of garbage."""
    g = torch.Generator(device=device).manual_seed(seed)
    b = len(depths)
    q = torch.randn(b, sq, h, d, generator=g, device=device).to(dtype)
    k = torch.randn(b, 2048, kv, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, 2048, kv, d, generator=g, device=device).to(dtype)
    offs = torch.tensor(depths, dtype=torch.int32, device=device)
    lens = torch.tensor(q_lens, dtype=torch.int32, device=device)
    kw = dict(scale=d ** -0.5, causal=True, window=window, softcap=softcap)
    if kv_layout == "dense":
        before = fa.launches
        out = fa.flash_attention(q, k, v, offs, lens, **kw)
        again = fa.flash_attention(q, k, v, offs, lens, **kw)
        assert fa.launches == before + 2
        ref = fa.flash_attention_plain(q, k, v, offs, lens, **kw)
    else:
        pk, pv, table = _card_paged_from_dense(k, v, int(kv_layout[1:]),
                                               np.random.default_rng(seed), depths, q_lens)
        before = fa.paged_launches
        out = fa.flash_attention_paged(q, pk, pv, table, offs, lens, **kw)
        again = fa.flash_attention_paged(q, pk, pv, table, offs, lens, **kw)
        assert fa.paged_launches == before + 2
        ref = fa.flash_attention_paged_plain(q, pk, pv, table, offs, lens, **kw)
        dense = fa.flash_attention(q, fa.paged_view(pk, table).contiguous(),
                                   fa.paged_view(pv, table).contiguous(), offs, lens, **kw)
        pk[-1] = 0
        pv[-1] = 0
        clean = fa.flash_attention_paged(q, pk, pv, table, offs, lens, **kw)
        torch.cuda.synchronize(device)
        assert torch.equal(out, dense)       # absolute splits: one order of sums
        assert torch.equal(out, clean)       # the trash page is never read
    torch.cuda.synchronize(device)
    _assert_within(out, ref)
    assert torch.equal(out, again)           # no atomics: the same bits twice
    for bi, n in enumerate(q_lens):
        assert not out[bi, n:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", _WINDOW_SOFTCAP, ids=["plain", "window_softcap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_layout", ["dense", "P16", "P48", "P64"])
@pytest.mark.parametrize("model", list(_MODEL_HEADS))
def test_flash_decode_kernel_on_card(cuda_device, model, kv_layout, dtype, window, softcap):
    """The split-KV decode kernel at each model's heads, one query a row at
    depths split-1 / split / split+1 / 0 / 2047 and an idle row."""
    h, kv, d = _MODEL_HEADS[model]
    depths, q_lens = _decode_depths(dtype, d)
    _card_decode_case(cuda_device, dtype, h=h, kv=kv, d=d, sq=1, depths=depths, q_lens=q_lens,
                      kv_layout=kv_layout, window=window, softcap=softcap)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_layout", ["dense", "P64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,h,kv,d", [(5, 4, 2, 64), (4, 32, 8, 64), (16, 16, 16, 128),
                                       (2, 32, 32, 80), (3, 4, 4, 80), (8, 16, 16, 256),
                                       (3, 4, 4, 256), (12, 16, 16, 256)])
def test_flash_decode_kernel_short_queries_on_card(cuda_device, sq, h, kv, d, dtype, kv_layout):
    """Sq > 1 with Sq·H/KV <= 16 rows (10, 16, 16, 2 and 3 rows: the
    16-row and 4-row register instances; at head dim 256, 8 and 3 rows on
    its 8-row instance, and 12, past the decode kernel's 8, on a chunk
    tile), rows past q_len zero."""
    _card_decode_case(cuda_device, dtype, h=h, kv=kv, d=d, sq=sq,
                      depths=[0, 255, 1900, 600], q_lens=[sq, sq - 1, 1, 0], kv_layout=kv_layout)


# ----------------------------------------------------------- SSD scan (-m gpu)
def _rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / (ref.float().abs().max() + 1e-9)).item()


def _card_ssd_inputs(device, dtype, *, b, s, h, p, g, n, init, seed=0):
    """The reference kernel test's distributions, drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen, device=device).to(dtype)
    dt = torch.randn(b, s, h, generator=gen, device=device).abs() * 0.1 + 0.01
    a = -(torch.randn(h, generator=gen, device=device).abs() + 0.5)
    bm = torch.randn(b, s, g, n, generator=gen, device=device).to(dtype)
    cm = torch.randn(b, s, g, n, generator=gen, device=device).to(dtype)
    st = torch.randn(b, h, p, n, generator=gen, device=device) if init else None
    return [x, dt, a, bm, cm], st


def _card_ssd_case(device, dtype, *, chunk, init, **shape):
    args, st = _card_ssd_inputs(device, dtype, init=init, **shape)
    before = ssd.launches
    y, fin = ssd.ssd_scan(*args, chunk, st)
    assert ssd.launches == before + 1
    yr, fr = ssd.ssd_scan_plain(*args, chunk, st)
    torch.cuda.synchronize(device)
    tol = 1e-5 if dtype == torch.float32 else 4e-2
    assert y.dtype == dtype and fin.dtype == torch.float32
    assert _rel(y, yr) < tol and _rel(fin, fr) < tol, (_rel(y, yr), _rel(fin, fr))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize(
    "b,s,h,p,g,n,chunk",
    [(2, 64, 4, 16, 1, 32, 16), (1, 128, 8, 64, 2, 64, 32), (2, 50, 4, 16, 4, 32, 16)],
)
def test_ssd_scan_kernel_reference_shapes_on_card(cuda_device, dtype, init, b, s, h, p, g, n,
                                                  chunk):
    """The reference kernel test's shapes (G = 2 and 4; S = 50 not a
    multiple of the chunk), from a zero and from a random initial state."""
    _card_ssd_case(cuda_device, dtype, chunk=chunk, init=init, b=b, s=s, h=h, p=p, g=g, n=n)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 17, 64, 200])
@pytest.mark.parametrize("model", ["mamba2-130m", "zamba2-2.7b"])
def test_ssd_scan_kernel_model_shapes_on_card(cuda_device, model, s):
    """mamba2-130m's heads (H 24, P 64, N 128) and zamba2-2.7b's (H 80,
    P 64, N 64), chunk 128: one partial chunk up to several chunks."""
    h, n = (24, 128) if model == "mamba2-130m" else (80, 64)
    for dtype in (torch.float32, torch.bfloat16):
        for init in (False, True):
            _card_ssd_case(cuda_device, dtype, chunk=128, init=init, b=2, s=s, h=h, p=64, g=1,
                           n=n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_masked_rows_freeze_the_state_on_card(cuda_device, dtype):
    """dt zeroed past a per-row length (the fused step's padding) leaves
    the final state equal to the state at that length."""
    args, st = _card_ssd_inputs(cuda_device, dtype, b=3, s=150, h=24, p=64, g=1, n=128,
                                init=True)
    lens = [150, 37, 0]
    keep = torch.arange(150, device=cuda_device)[None, :, None] < torch.tensor(
        lens, device=cuda_device)[:, None, None]
    args[1] = args[1] * keep
    _, fin = ssd.ssd_scan(*args, 128, st)
    tol = 1e-5 if dtype == torch.float32 else 4e-2
    for bi, n in enumerate(lens):
        if n == 0:
            ref = st[bi]
        else:
            row = [t[bi:bi + 1, :n].contiguous() for t in (args[0], args[1])]
            _, ref = ssd.ssd_scan(row[0], row[1], args[2], args[3][bi:bi + 1, :n].contiguous(),
                                  args[4][bi:bi + 1, :n].contiguous(), 128, st[bi:bi + 1])
            ref = ref[0]
        torch.cuda.synchronize(cuda_device)
        assert _rel(fin[bi], ref) < tol, (bi, _rel(fin[bi], ref))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["mamba2-130m", "zamba2-2.7b"])
def test_ssd_scan_kernel_updates_the_state_in_place_on_card(cuda_device, model):
    """``out_state`` = ``init_state``: the kernel writes the final state
    over the initial one (the model's cache) and agrees with the plain
    version on a separate copy."""
    h, n = (24, 128) if model == "mamba2-130m" else (80, 64)
    for dtype in (torch.float32, torch.bfloat16):
        args, st = _card_ssd_inputs(cuda_device, dtype, b=8, s=64, h=h, p=64, g=1, n=n,
                                    init=True)
        yr, fr = ssd.ssd_scan_plain(*args, 128, st.clone())
        y, fin = ssd.ssd_scan(*args, 128, st, out_state=st)
        torch.cuda.synchronize(cuda_device)
        assert fin.data_ptr() == st.data_ptr()
        tol = 1e-5 if dtype == torch.float32 else 4e-2
        assert _rel(y, yr) < tol and _rel(st, fr) < tol, (_rel(y, yr), _rel(st, fr))


@pytest.mark.gpu
def test_ssd_scan_wrapper_raises_on_inputs_the_kernel_does_not_take(cuda_device):
    args, st = _card_ssd_inputs(cuda_device, torch.float32, b=1, s=8, h=4, p=16, g=1, n=32,
                                init=True)
    x, dt, a, bm, cm = args
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.half(), dt, a, bm, cm, 16)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt.double(), a, bm, cm, 16)
    with pytest.raises(ValueError, match="N must be one of"):
        ssd.ssd_scan(x, dt, a, bm[..., :24].contiguous(), cm[..., :24].contiguous(), 16)
    with pytest.raises(ValueError, match="N must be one of"):
        ssd.ssd_scan(x, dt, a, bm[..., :16].contiguous(), cm[..., :16].contiguous(), 16)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan(x, dt, a, bm, cm, 256)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, bm, cm, 16)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt, a, bm, cm, 16, st.to(torch.bfloat16))
    with pytest.raises(TypeError, match="out_state"):
        ssd.ssd_scan(x, dt, a, bm, cm, 16, st, out_state=st[:, :2].contiguous())


# ------------------------------------ the bf16 SSD tensor-core kernel's model
_LOG2E_F32 = torch.tensor(_LOG2E, dtype=torch.float32)
# kernel vs model on the card: max err over max |ref|.  Both round the same
# scores and W entries to bf16; an entry whose fp32 value lies within a few
# ulps of a rounding tie (cumsum and mma sum in another order, ex2.approx)
# rounds to the neighbouring bf16, one 2^-8 step of one term of a row.
_SSD_MODEL_TOL = 4e-3
# (b, s, h, p, g, n, chunk, init): both models' fused chunk (8 × 64, carried
# state), mamba2's heads over two chunks (S 200), a reference shape at G 2
_SSD_MODEL_CASES = {
    "mamba2_fused_chunk": (8, 64, 24, 64, 1, 128, 128, True),
    "zamba2_fused_chunk": (8, 64, 80, 64, 1, 64, 128, True),
    "mamba2_S200": (2, 200, 24, 64, 1, 128, 128, True),
    "reference_G2": (1, 128, 8, 64, 2, 64, 32, False),
}


def _ssd_tile_model(x, dt, A, B, C, chunk, init_state=None):
    """The arithmetic of the bf16 SSD tensor-core kernel in plain PyTorch,
    chunk by chunk: cum = cumsum(dt·A·log2 e) in fp32; y = (C · (hi +
    lo)ᵀ) 2^{cum_i} with the fp32 state split into bf16 hi = bf16(s) and lo
    = bf16(s − hi); scores C·Bᵀ ⊙ 2^{cum_i − cum_j} ⊙ dt_j (zero above the
    diagonal) rounded to bf16, times x; W = bf16(B ⊙ dt·2^{cum_last − cum});
    state = state·2^{cum_last} + xᵀW in fp32.  B, C and x are bf16 already,
    so every other product is exact in its inputs."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    bf = torch.bfloat16
    xf = x.float()
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    st = (init_state.float().clone() if init_state is not None
          else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    a_log2 = A.float() * _LOG2E_F32.to(x.device)
    ys = []
    for c0 in range(0, s, chunk):
        lc = min(chunk, s - c0)
        xc, dtc = xf[:, c0:c0 + lc], dt[:, c0:c0 + lc].float()
        Bc, Cc = Bh[:, c0:c0 + lc], Ch[:, c0:c0 + lc]
        cum = torch.cumsum(dtc * a_log2, dim=1)                      # [b, L, h]
        hi = st.to(bf).float()
        lo = (st - hi).to(bf).float()
        y = (torch.einsum("blhn,bhpn->blhp", Cc, hi) + torch.einsum("blhn,bhpn->blhp", Cc, lo)
             ) * torch.exp2(cum)[..., None]
        scores = torch.einsum("bihn,bjhn->bhij", Cc, Bc)
        ch = cum.permute(0, 2, 1)                                    # [b, h, L]
        vis = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=x.device))
        diff = torch.where(vis, ch[..., :, None] - ch[..., None, :], torch.zeros(()))
        decay = torch.where(vis, torch.exp2(diff), torch.zeros(()))
        sd = (scores * decay * dtc.permute(0, 2, 1)[:, :, None, :]).to(bf).float()
        ys.append((y + torch.einsum("bhij,bjhp->bihp", sd, xc)).to(x.dtype))
        w = dtc * torch.exp2(cum[:, -1:] - cum)                     # [b, L, h]
        W = (Bc * w[..., None]).to(bf).float()
        st = st * torch.exp2(cum[:, -1])[..., None, None] + torch.einsum("blhp,blhn->bhpn", xc, W)
    return torch.cat(ys, dim=1), st


def _ssd_model_inputs(rng, b, s, h, p, g, n, init):
    """The reference kernel test's distributions from numpy: x, B, C in
    bf16, dt and A fp32, an fp32 initial state when ``init``."""
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32)).to(bf)
    dt = torch.from_numpy((np.abs(rng.standard_normal((b, s, h))) * 0.1 + 0.01).astype(np.float32))
    a = torch.from_numpy((-(np.abs(rng.standard_normal(h)) + 0.5)).astype(np.float32))
    bm = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(np.float32)).to(bf)
    cm = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(np.float32)).to(bf)
    st = torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(np.float32)) if init else None
    return [x, dt, a, bm, cm], st


@pytest.mark.parametrize("case", list(_SSD_MODEL_CASES))
def test_ssd_tile_model_within_bf16_tolerance(case):
    """The rounding of the bf16 SSD kernel (scores and W in bf16, the state
    as a hi + lo bf16 pair) stays within the bf16 tolerance (4e-2 of max
    |ref|, y and final state) of the plain version, which is fp32 from end
    to end, and of the reference's jnp ``ssd_chunked`` on the same values."""
    from repro.models import ssm as j_ssm

    jnp = _jax()
    b, s, h, p, g, n, chunk, init = _SSD_MODEL_CASES[case]
    args, st = _ssd_model_inputs(np.random.default_rng(0), b, s, h, p, g, n, init)
    y, fin = _ssd_tile_model(*args, chunk, st)
    yr, fr = ssd.ssd_scan_plain(*args, chunk, st)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    assert _rel(y, yr) < 4e-2 and _rel(fin, fr) < 4e-2, (_rel(y, yr), _rel(fin, fr))
    assert not torch.equal(y, yr) and not torch.equal(fin, fr)   # the rounding is modelled
    jargs = [jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                         else jnp.float32) for t in args]
    yj, fj = j_ssm.ssd_chunked(*jargs, chunk,
                               init_state=None if st is None else jnp.asarray(st.numpy()))
    yj = torch.from_numpy(np.array(yj, np.float32))
    fj = torch.from_numpy(np.array(fj, np.float32))
    assert _rel(y, yj) < 4e-2 and _rel(fin, fj) < 4e-2, (_rel(y, yj), _rel(fin, fj))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_SSD_MODEL_CASES) + [
    "reference_P16_G4_S50", "zamba2_S17", "mamba2_S1", "mamba2_chunk7"])
def test_ssd_scan_mma_kernel_matches_its_model_on_card(cuda_device, case):
    """The bf16 tensor-core kernel against ``_ssd_tile_model`` on the same
    inputs, within ``_SSD_MODEL_TOL``, and two launches bit-identical; it
    must have run the tensor-core kernel."""
    shape = _SSD_MODEL_CASES.get(case) or {
        "reference_P16_G4_S50": (2, 50, 4, 16, 4, 32, 16, True),
        "zamba2_S17": (2, 17, 80, 64, 1, 64, 128, True),
        "mamba2_S1": (2, 1, 24, 64, 1, 128, 128, True),
        "mamba2_chunk7": (1, 100, 24, 64, 1, 128, 7, True),
    }[case]
    b, s, h, p, g, n, chunk, init = shape
    args, st = _ssd_model_inputs(np.random.default_rng(0), b, s, h, p, g, n, init)
    args = [t.to(cuda_device) for t in args]
    st = None if st is None else st.to(cuda_device)
    before = ssd.mma_launches
    y, fin = ssd.ssd_scan(*args, chunk, st)
    y2, fin2 = ssd.ssd_scan(*args, chunk, st)
    ym, fm = _ssd_tile_model(*args, chunk, st)
    torch.cuda.synchronize(cuda_device)
    assert ssd.mma_launches == before + 2
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    assert _rel(y, ym) < _SSD_MODEL_TOL and _rel(fin, fm) < _SSD_MODEL_TOL, (
        _rel(y, ym), _rel(fin, fm))


@pytest.mark.gpu
def test_ssd_scan_runs_each_dtype_on_its_kernel_on_card(cuda_device):
    """bf16 calls run the tensor-core kernel, fp32 calls the CUDA-core one."""
    for dtype, attr in ((torch.bfloat16, "mma_launches"), (torch.float32, "core_launches")):
        args, st = _card_ssd_inputs(cuda_device, dtype, b=2, s=64, h=4, p=64, g=1, n=64,
                                    init=True)
        before = (ssd.launches, ssd.mma_launches, ssd.core_launches)
        ssd.ssd_scan(*args, 128, st)
        after = (ssd.launches, ssd.mma_launches, ssd.core_launches)
        assert after[0] == before[0] + 1
        assert getattr(ssd, attr) == before[1 if attr == "mma_launches" else 2] + 1
        assert sum(after[1:]) == sum(before[1:]) + 1


@pytest.mark.gpu
def test_ssd_scan_bf16_wrapper_raises_on_p_not_a_multiple_of_16(cuda_device):
    args, st = _card_ssd_inputs(cuda_device, torch.bfloat16, b=1, s=8, h=4, p=24, g=1, n=32,
                                init=True)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd.ssd_scan(*args, 16, st)


# ------------------------------------------------------ grouped GEMM (-m gpu)
def _card_gg_case(device, dtype, *, sizes, k, n, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    e, m = len(sizes), int(sum(sizes))
    x = torch.randn(m, k, generator=g, device=device).to(dtype)
    w = (torch.randn(e, k, n, generator=g, device=device) * k ** -0.5).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=device)
    before = gg.launches
    out = gg.grouped_gemm(x, w, gs)
    assert gg.launches == before + 1
    ref = gg.grouped_gemm_plain(x, w, gs)
    torch.cuda.synchronize(device)
    _assert_within(out, ref)


def _routed_sizes(tokens, top_k, e_real, e_pad, seed):
    """Group sizes of ``tokens`` tokens routed top-``k`` over ``e_real`` of
    ``e_pad`` experts (the padding experts empty)."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(e_real, top_k, replace=False) for _ in range(tokens)])
    return np.bincount(ids.ravel(), minlength=e_pad).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)], ids=["gate_up", "down"])
@pytest.mark.parametrize("routing", ["decode", "chunk"])
def test_grouped_gemm_kernel_at_qwen2_moe_shapes_on_card(cuda_device, dtype, k, n, routing):
    """qwen2-moe-a2.7b's expert products: 8 decode tokens (M = 32, about one
    row an expert) or a fused chunk of 8 × 64 tokens (M = 2048 over the 60
    real of 64 experts), top-4."""
    tokens = 8 if routing == "decode" else 512
    _card_gg_case(cuda_device, dtype, sizes=_routed_sizes(tokens, 4, 60, 64, seed=k), k=k, n=n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "sizes",
    [[200, 0, 0, 0], [0, 0, 0, 77], [1, 0, 64, 65, 0, 1], [129] + [0] * 7, [3, 5, 0, 1]],
    ids=["one_expert", "last_expert", "ragged", "past_two_tiles", "tiny"],
)
def test_grouped_gemm_kernel_edge_groups_on_card(cuda_device, dtype, sizes):
    """All rows in one expert, the last expert only, groups of one row, M
    not a multiple of the 64-row tile, and a K and N tail."""
    _card_gg_case(cuda_device, dtype, sizes=sizes, k=136, n=200)


def _card_gg_inputs(device, *, sizes, k, n, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(int(sum(sizes)), k, generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn(len(sizes), k, n, generator=g, device=device) * k ** -0.5).to(torch.bfloat16)
    return x, w, torch.tensor(sizes, dtype=torch.int32, device=device)


def _spread_rows(m, seed=0):
    """``m`` rows spread at random over 60 real of 64 experts."""
    rng = np.random.default_rng(seed)
    return np.bincount(rng.integers(0, 60, size=m), minlength=64).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)], ids=["gate_up", "down"])
@pytest.mark.parametrize("side", [0, 1], ids=["split", "whole"])
def test_grouped_gemm_kernel_on_each_side_of_the_split_threshold_on_card(cuda_device, k, n, side):
    """The largest M this card splits K for, and one row more (bf16)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    m = max(m for m in range(1, 1024) if gg.split_k(m, k, n, 64, sms) > 1) + side
    assert (gg.split_k(m, k, n, 64, sms) > 1) == (side == 0)
    _card_gg_case(cuda_device, torch.bfloat16, sizes=_spread_rows(m, seed=m), k=k, n=n)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1408, 2048])
def test_grouped_gemm_kernel_k_tail_in_the_last_split_on_card(cuda_device, n):
    """K = 1416 at decode routing: the last K split ends in an 8-deep tail,
    zero-filled by the tensor map, never the next expert's rows."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    sizes = _routed_sizes(8, 4, 60, 64, seed=n)
    assert gg.split_k(32, 1416, n, 64, sms) > 1
    _card_gg_case(cuda_device, torch.bfloat16, sizes=sizes, k=1416, n=n)


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [8, 512], ids=["decode", "chunk"])
def test_grouped_gemm_kernel_two_launches_are_bit_identical_on_card(cuda_device, tokens):
    """The split partials are summed in split order, with no float atomics,
    and the unit schedule does not change a bit."""
    x, w, gs = _card_gg_inputs(cuda_device, sizes=_routed_sizes(tokens, 4, 60, 64, seed=1),
                               k=2048, n=1408)
    a = gg.grouped_gemm(x, w, gs)
    b = gg.grouped_gemm(x, w, gs)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_grouped_gemm_kernel_interleaved_shapes_on_card(cuda_device):
    """Calls of different shapes and split counts, one after another, three
    times: a unit or arrival counter left unreset by one call would break
    the next."""
    cases = [
        _card_gg_inputs(cuda_device, sizes=_routed_sizes(8, 4, 60, 64, seed=2), k=2048, n=1408),
        _card_gg_inputs(cuda_device, sizes=_routed_sizes(512, 4, 60, 64, seed=3), k=1408, n=2048),
        _card_gg_inputs(cuda_device, sizes=_routed_sizes(8, 4, 60, 64, seed=4), k=1416, n=2048),
        _card_gg_inputs(cuda_device, sizes=[3, 5, 0, 1], k=136, n=200),
    ]
    refs = [gg.grouped_gemm_plain(*c) for c in cases]
    for _ in range(3):
        for c, ref in zip(cases, refs):
            out = gg.grouped_gemm(*c)
            torch.cuda.synchronize(cuda_device)
            _assert_within(out, ref)


@pytest.mark.gpu
def test_grouped_gemm_kernel_zeroes_rows_past_the_last_group(cuda_device):
    x = torch.randn(100, 64, device=cuda_device)
    w = torch.randn(3, 64, 32, device=cuda_device) * 0.125
    gs = torch.tensor([10, 0, 20], dtype=torch.int32, device=cuda_device)
    out = gg.grouped_gemm(x, w, gs)
    torch.cuda.synchronize(cuda_device)
    assert not out[30:].any()
    _assert_within(out, gg.grouped_gemm_plain(x, w, gs))


@pytest.mark.gpu
def test_grouped_gemm_wrapper_raises_on_inputs_the_kernel_does_not_take(cuda_device):
    x = torch.randn(16, 64, device=cuda_device)
    w = torch.randn(2, 64, 32, device=cuda_device)
    gs = torch.tensor([8, 8], dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        gg.grouped_gemm(x.to(torch.bfloat16), w, gs)
    with pytest.raises(TypeError):
        gg.grouped_gemm(x, w, gs.long())
    with pytest.raises(ValueError):
        gg.grouped_gemm(x[:, :60].contiguous(), w[:, :60].contiguous(), gs)   # K % 8
    with pytest.raises(ValueError):
        gg.grouped_gemm(x, w[:, :, :30].contiguous(), gs)                     # N % 8
    with pytest.raises(ValueError):
        gg.grouped_gemm(x.t().contiguous().t(), w, gs)                        # not contiguous
    with pytest.raises(ValueError):
        gg.grouped_gemm(x, w, gs.cpu())

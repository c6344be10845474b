"""The port's kernels: plain versions against the reference's Pallas kernels
(interpret mode on the CPU), the CPU dispatch of the wrappers, and — on a
CUDA card only (``-m gpu``) — each CUDA kernel against its plain version.

Tolerances: fp32 2e-4 and bf16 3e-2 against the Pallas kernels (as
``test_kernels.py``); 2e-5 against the ragged-row oracle (as
``test_fused_step.py``); on the card fp32 1e-4 max abs, bf16 atol 1e-2 +
rtol 1e-2 (the two sides may round one fp32 value to neighbouring bf16
values, one bf16 ulp: 2^-8 relative).

The JAX reference is imported inside the tests that compare against it, so
the card tests run where only the port is installed:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn


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


# --------------------------------------------------------------- flash attn
# the cases of test_kernels.py::test_flash_attention_kernel
CASES = [
    # b, sq, sk, h, kv, d, window, cap
    (2, 128, 128, 4, 2, 64, 0, 0.0),
    (1, 256, 256, 8, 8, 128, 64, 50.0),   # window + softcap (gemma2)
    (2, 96, 96, 4, 1, 80, 0, 0.0),        # MQA + unaligned dims
    (1, 128, 384, 2, 2, 64, 0, 0.0),      # long KV (q_offset)
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
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_kernel_head_dims_on_card(cuda_device, d):
    """The kernel is built for head dim 64; the wrapper refuses the others."""
    if d != 64:
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

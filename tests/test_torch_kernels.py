"""The port's kernels held against the JAX package's Pallas kernels.

On the CPU the port runs each kernel's plain PyTorch version; here it is
compared with the JAX kernel in interpret mode on the same numpy inputs,
over the cases and tolerances of tests/test_kernels.py (f32 2e-5, bf16
2e-2).  The CUDA kernels themselves run only on the card: those tests carry
the ``cuda`` marker and skip elsewhere (``python3 chip_smoke.py`` drives
them at the serving path's shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}

ATTN_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0),      # MHA causal
    (2, 256, 256, 8, 2, 64, True, 0),      # GQA causal
    (1, 192, 192, 4, 2, 32, True, 64),     # sliding window (+pad)
    (2, 64, 160, 4, 4, 64, False, 0),      # cross attention, Sq != Sk
    (1, 100, 100, 2, 1, 16, True, 0),      # ragged (padding path)
]
NORM_SHAPES = [(8, 64), (3, 7, 96), (1, 384), (130, 256)]


def _pair(arr: np.ndarray, dt: str):
    """The same f32 numbers as a JAX and a torch array of dtype `dt`
    (both round f32 -> bf16 to nearest even)."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _np32(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA/Triton kernels have no "
                    "CPU mode); run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", ATTN_CASES)
def test_attention_plain_matches_jax_kernel(B, Sq, Sk, H, KV, hd, causal,
                                            window, dt):
    rng = np.random.default_rng(0)
    qn, kn, vn = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    (qj, qt), (kj, kt), (vj, vt) = _pair(qn, dt), _pair(kn, dt), _pair(vn, dt)
    want = jax_flash(qj, kj, vj, causal=causal, window=window,
                     block_q=64, block_k=64, interpret=True)
    got = fa.attention_plain(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np32(got), _np32(want), **TOL[dt])
    # the naive oracle agrees too
    np.testing.assert_allclose(
        _np32(ref.attention_ref(qt, kt, vt, causal=causal, window=window)),
        _np32(want), **TOL[dt])


def test_attention_plain_fully_masked_row_is_zero():
    """A row that sees no key gives 0 (the kernel's contract), where the
    naive oracle gives NaN."""
    q = torch.randn(1, 4, 2, 16)
    k = torch.randn(1, 2, 2, 16)
    v = torch.randn(1, 2, 2, 16)
    # non-causal window 1: query i sees key i only, so rows 2, 3 see none
    out = fa.attention_plain(q, k, v, causal=False, window=1)
    assert torch.isfinite(out).all()
    assert torch.equal(out[:, 2:], torch.zeros_like(out[:, 2:]))
    assert torch.isnan(ref.attention_ref(q, k, v, causal=False,
                                         window=1)[:, 2:]).all()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_rmsnorm_plain_matches_jax_kernel(shape, dt):
    rng = np.random.default_rng(1)
    xn = rng.standard_normal(shape).astype(np.float32)
    sn = rng.standard_normal(shape[-1]).astype(np.float32)
    xj, xt = _pair(xn, dt)
    want = jax_rmsnorm(xj, jnp.asarray(sn), block_rows=32, interpret=True)
    got = rn.rmsnorm_plain(xt, torch.from_numpy(sn))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np32(got), _np32(want), **TOL[dt])
    np.testing.assert_allclose(_np32(ref.rmsnorm_ref(xt, torch.from_numpy(sn))),
                               _np32(want), **TOL[dt])


def test_ops_on_cpu_take_the_plain_path(monkeypatch):
    """CPU tensors go to the plain versions; no kernel launch is counted."""
    monkeypatch.setattr(fa, "launches", 0)
    monkeypatch.setattr(rn, "launches", 0)
    q = torch.randn(2, 64, 4, 32)
    k = torch.randn(2, 64, 2, 32)
    v = torch.randn(2, 64, 2, 32)
    torch.testing.assert_close(ops.attention(q, k, v, causal=True),
                               fa.attention_plain(q, k, v, causal=True),
                               rtol=0, atol=0)
    x = torch.randn(4, 16, 128)
    s = torch.full((128,), 1.5)
    torch.testing.assert_close(ops.rmsnorm(x, s), rn.rmsnorm_plain(x, s),
                               rtol=0, atol=0)
    assert fa.launches == 0 and rn.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points never run the plain version themselves."""
    q = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(torch.randn(2, 8), torch.ones(8))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", ATTN_CASES)
def test_flash_kernel_matches_plain_on_card(B, Sq, Sk, H, KV, hd, causal,
                                            window, dt, cuda_device):
    tdt = DTYPES[dt][1]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(tdt)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(
        got.float(), fa.attention_plain(q, k, v, causal=causal,
                                        window=window).float(), **TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", NORM_SHAPES + [(2048, 1024), (4, 1024)])
def test_rmsnorm_kernel_matches_plain_on_card(shape, dt, cuda_device):
    tdt = DTYPES[dt][1]
    x = torch.randn(shape, device=cuda_device).to(tdt)
    s = torch.randn(shape[-1], device=cuda_device)
    got = rn.rmsnorm(x, s)
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), rn.rmsnorm_plain(x, s).float(),
                               **TOL[dt])

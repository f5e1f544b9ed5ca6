"""The port's kernels held against the JAX package's Pallas kernels.

On the CPU the port runs each kernel's plain PyTorch version; here it is
compared with the JAX kernel in interpret mode on the same numpy inputs,
over the cases and tolerances of tests/test_kernels.py (f32 2e-5, bf16
2e-2; SSD y 2e-4 f32 / 5e-2 bf16, h 1e-4).  The CUDA kernels themselves run only on the card: those tests carry
the ``cuda`` marker and skip elsewhere (``python3 chip_smoke.py`` drives
them at the serving path's shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}

ATTN_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0),      # MHA causal
    (2, 256, 256, 8, 2, 64, True, 0),      # GQA causal
    (1, 192, 192, 4, 2, 32, True, 64),     # sliding window (+pad)
    (2, 64, 160, 4, 4, 64, False, 0),      # cross attention, Sq != Sk
    (1, 100, 100, 2, 1, 16, True, 0),      # ragged (padding path)
    (1, 128, 128, 8, 2, 128, True, 0),     # hd 128, GQA (phi3-medium's)
    (1, 96, 96, 8, 2, 80, True, 32),       # hd 80 + window (h2o-danube's)
    (2, 4, 4, 6, 6, 64, True, 0),          # whisper's 4-token causal prefill
    (2, 4, 150, 6, 6, 64, False, 0),       # whisper's cross attention
]
NORM_SHAPES = [(8, 64), (3, 7, 96), (1, 384), (130, 256)]
# (B, S, nh, P, N, chunk): tests/test_kernels.py:70-74
SSD_CASES = [
    (1, 64, 2, 16, 32, 16),
    (2, 100, 3, 32, 64, 32),     # ragged: S % chunk != 0
    (1, 128, 1, 64, 128, 128),   # single chunk
]
# the tensor-core kernel's model at the reference's cases and at P = 64
# with N = 16 (Jamba) and N = 128 (mamba2), S ragged against its tile
SSD_TC_CASES = SSD_CASES + [
    (2, 150, 3, 64, 16, 128),
    (1, 200, 2, 64, 128, 64),
    (2, 77, 2, 64, 128, 128),
]
SSD_TOL = {"f32": dict(rtol=2e-4, atol=2e-4),
           "bf16": dict(rtol=5e-2, atol=5e-2)}
SSD_H_TOL = dict(rtol=1e-4, atol=1e-4)


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


def _ssd_inputs(B, S, nh, P, N, seed=3):
    """x, dt (post-softplus), A (negative), Bm, Cm as f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,nh,P,N,chunk", SSD_CASES)
def test_ssd_plain_matches_jax_kernel(B, S, nh, P, N, chunk, dt):
    xn, dtn, An, Bn, Cn = _ssd_inputs(B, S, nh, P, N)
    (xj, xt), (bj, bt), (cj, ct) = _pair(xn, dt), _pair(Bn, dt), _pair(Cn, dt)
    dtt, At = torch.from_numpy(dtn), torch.from_numpy(An)
    yj, hj = jax_ssd(xj, jnp.asarray(dtn), jnp.asarray(An), bj, cj,
                     chunk=chunk, interpret=True)
    y, h = ssd.ssd_plain(xt, dtt, At, bt, ct, chunk=chunk)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    assert h.dtype == torch.float32 and h.shape == (B, nh, P, N)
    np.testing.assert_allclose(_np32(y), _np32(yj), **SSD_TOL[dt])
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **SSD_H_TOL)
    # the naive token-by-token oracle agrees too
    y_r, h_r = ref.ssd_ref(xt, dtt, At, bt, ct)
    assert y_r.dtype == xt.dtype
    np.testing.assert_allclose(_np32(y_r), _np32(yj), **SSD_TOL[dt])
    np.testing.assert_allclose(h_r.numpy(), np.asarray(hj), **SSD_H_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 48, 8, 128])
def test_ssd_plain_chunk_invariance(chunk):
    """tests/test_kernels.py:92-107: the result does not depend on the
    chunk (8: a partial last chunk; 128 > S: one chunk of S steps)."""
    xn, dtn, An, Bn, Cn = (torch.from_numpy(a) for a in
                           _ssd_inputs(1, 96, 2, 16, 32, seed=4))
    y0, h0 = ssd.ssd_plain(xn, dtn, An, Bn, Cn, chunk=96)
    y, h = ssd.ssd_plain(xn, dtn, An, Bn, Cn, chunk=chunk)
    torch.testing.assert_close(y, y0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, h0, rtol=2e-4, atol=2e-4)


def test_ssd_initial_state_matches_jax_ref():
    """h0 carries into both the plain version and the oracle as into the
    reference's ``ref.ssd_ref``."""
    xn, dtn, An, Bn, Cn = _ssd_inputs(2, 21, 2, 16, 16, seed=6)
    h0 = np.random.default_rng(7).standard_normal(
        (2, 2, 16, 16)).astype(np.float32)
    yj, hj = jax_ref.ssd_ref(*(jnp.asarray(a) for a in
                               (xn, dtn, An, Bn, Cn)), h0=jnp.asarray(h0))
    args = [torch.from_numpy(a) for a in (xn, dtn, An, Bn, Cn)]
    for y, h in (ssd.ssd_plain(*args, chunk=8, h0=torch.from_numpy(h0)),
                 ref.ssd_ref(*args, h0=torch.from_numpy(h0))):
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SSD_TOL["f32"])
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), **SSD_H_TOL)


def test_ssd_plain_upper_triangle_never_overflows():
    """Large dt·|A| makes cum_i - cum_j huge above the diagonal; masking
    before the exp keeps inf (and inf·0 = NaN) out."""
    xn, dtn, An, Bn, Cn = (torch.from_numpy(a) for a in
                           _ssd_inputs(1, 64, 2, 16, 16, seed=8))
    y, h = ssd.ssd_plain(xn, dtn * 40.0, An * 3.0, Bn, Cn, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    y_r, h_r = ref.ssd_ref(xn, dtn * 40.0, An * 3.0, Bn, Cn)
    torch.testing.assert_close(y, y_r, rtol=2e-4, atol=2e-4)


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
    monkeypatch.setattr(ssd, "launches", 0)
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, 20, 2, 16, 16)]
    for got, want in zip(ops.ssd(*args, chunk=8),
                         ssd.ssd_plain(*args, chunk=8)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fa.launches == 0 and rn.launches == 0 and ssd.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points never run the plain version themselves."""
    q = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(torch.randn(2, 8), torch.ones(8))
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, 20, 2, 16, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(*args)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 80, "tc"), (torch.bfloat16, 16, "tc"),
    (torch.bfloat16, 32, "tc"), (torch.bfloat16, 48, "fma"),
    (torch.bfloat16, 112, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"),
])
def test_flash_variant_dispatch(dtype, hd, want):
    """bf16 at the zoo's head dims runs on the tensor cores; f32 (which
    TF32 tensor cores could not hold to 2e-5) and other head dims on the
    CUDA cores, chosen before any launch."""
    assert fa.variant(dtype, hd) == want
    assert hd in (fa.TC_HEAD_DIMS if want == "tc" else fa.FMA_HEAD_DIMS)


@pytest.mark.parametrize("dtype,hd", [
    (torch.bfloat16, 24), (torch.bfloat16, 256), (torch.float32, 8),
    (torch.float16, 64),
])
def test_flash_variant_rejects_what_no_kernel_takes(dtype, hd):
    with pytest.raises(ValueError):
        fa.variant(dtype, hd)


@pytest.mark.parametrize("d", [1, 7, 64, 96, 384, 1000, 1024, 2560, 2816,
                               5120])
def test_rmsnorm_split_blocks_cover_the_row(d):
    """The "split" design's two power-of-two blocks cover d exactly once,
    the first unmasked; at the serving widths no lane is masked.  With
    one row per program the row is one power-of-two block."""
    a, b = rn.split_blocks(d)
    assert a & (a - 1) == 0 and a <= d < 2 * a
    assert (b == 0) == (a == d)
    if b:
        assert b & (b - 1) == 0 and b >= d - a > b // 2
    if d in (1024, 2560, 5120):
        assert a + b == d
    a, b = rn.split_blocks(d, one_row=True)
    assert b == 0 and a & (a - 1) == 0 and a >= d > a // 2


def test_ssd_scan_rejects_unsupported_head_dim_and_state():
    for P, N in ((48, 16), (16, 256), (128, 128)):
        args = [torch.from_numpy(a) for a in _ssd_inputs(1, 4, 1, P, N)]
        with pytest.raises(ValueError, match="P in"):
            ssd.ssd_scan(*args)


@pytest.mark.parametrize("B,S,nh,P,N,chunk", SSD_TC_CASES)
def test_ssd_tc_plain_matches_jax_kernel(B, S, nh, P, N, chunk):
    """The tensor-core kernel's numerics (bf16 hi + lo splits of the state
    factor, h_prev and G, its own tile) against the Pallas kernel, at the
    reference's tolerances: a wrong precision design fails here."""
    xn, dtn, An, Bn, Cn = _ssd_inputs(B, S, nh, P, N)
    (xj, xt), (bj, bt), (cj, ct) = (_pair(a, "bf16") for a in (xn, Bn, Cn))
    yj, hj = jax_ssd(xj, jnp.asarray(dtn), jnp.asarray(An), bj, cj,
                     chunk=chunk, interpret=True)
    y, h = ssd.ssd_tc_plain(xt, torch.from_numpy(dtn), torch.from_numpy(An),
                            bt, ct, chunk=chunk)
    assert y.dtype == torch.bfloat16 and y.shape == xt.shape
    assert h.dtype == torch.float32 and h.shape == (B, nh, P, N)
    np.testing.assert_allclose(_np32(y), _np32(yj), **SSD_TOL["bf16"])
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **SSD_H_TOL)


def test_ssd_tc_state_needs_the_hi_lo_split():
    """With the state factor and h_prev each rounded once to bf16 the state
    misses the 1e-4 tolerance: the split is what holds it."""
    xn, dtn, An, Bn, Cn = _ssd_inputs(1, 128, 1, 64, 128)
    args = (torch.from_numpy(xn).bfloat16(), torch.from_numpy(dtn),
            torch.from_numpy(An), torch.from_numpy(Bn).bfloat16(),
            torch.from_numpy(Cn).bfloat16())
    _, h_want = ssd.ssd_plain(*args)
    _, h_split = ssd.ssd_tc_plain(*args)
    _, h_once = ssd._chunked(*args, 128, None,
                             lambda v: (v.to(torch.bfloat16).float(),))
    torch.testing.assert_close(h_split, h_want, **SSD_H_TOL)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(h_once, h_want, **SSD_H_TOL)


@pytest.mark.parametrize("dtype,P,N,want", [
    (torch.bfloat16, 64, 128, "tc"), (torch.bfloat16, 64, 16, "tc"),
    (torch.bfloat16, 64, 32, "tc"), (torch.bfloat16, 64, 64, "tc"),
    (torch.bfloat16, 16, 16, "fma"), (torch.bfloat16, 32, 64, "fma"),
    (torch.float32, 64, 128, "fma"), (torch.float32, 16, 32, "fma"),
])
def test_ssd_variant_dispatch(dtype, P, N, want):
    """bf16 at P = 64 (mamba2, Jamba) runs on the tensor cores; f32 and
    P = 16 or 32 on the CUDA cores, chosen before any launch."""
    assert ssd.variant(dtype, P, N) == want


@pytest.mark.parametrize("dtype,P,N", [
    (torch.bfloat16, 48, 128), (torch.bfloat16, 64, 256),
    (torch.float32, 128, 16), (torch.float16, 64, 128),
])
def test_ssd_variant_rejects_what_no_kernel_takes(dtype, P, N):
    with pytest.raises(ValueError):
        ssd.variant(dtype, P, N)


@pytest.mark.parametrize("chunk,tile", [(1, 64), (32, 64), (64, 64),
                                        (65, 128), (128, 128), (256, 128)])
def test_ssd_tc_tile(chunk, tile):
    assert ssd.tc_tile(chunk) == tile


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_tc_plain_chunk_invariance(chunk):
    """The tensor-core model at tiles 64 and 128 against the plain version
    at one chunk."""
    xn, dtn, An, Bn, Cn = _ssd_inputs(1, 160, 2, 64, 32, seed=4)
    args = (torch.from_numpy(xn).bfloat16(), torch.from_numpy(dtn),
            torch.from_numpy(An), torch.from_numpy(Bn).bfloat16(),
            torch.from_numpy(Cn).bfloat16())
    y0, h0 = ssd.ssd_plain(*args, chunk=160)
    y, h = ssd.ssd_tc_plain(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), y0.float(), **SSD_TOL["bf16"])
    torch.testing.assert_close(h, h0, **SSD_H_TOL)


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
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (2, 256, 256, 40, 10, 128, True, 0),
    (1, 192, 192, 32, 8, 80, True, 64),
    (4, 512, 512, 16, 16, 64, True, 0),
])
def test_flash_tc_kernel_at_the_zoo_shapes_on_card(B, Sq, Sk, H, KV, hd,
                                                   causal, window,
                                                   cuda_device,
                                                   monkeypatch):
    """bf16 at hd 128 (GQA 40/10), hd 80 with a window and qwen1.5's
    prefill go through the tensor-core kernel, match the plain version and
    give the same bits twice."""
    monkeypatch.setattr(fa, "launches_tc", 0)
    monkeypatch.setattr(fa, "launches_fma", 0)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).bfloat16()
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches_tc == 1 and fa.launches_fma == 0
    torch.testing.assert_close(
        got.float(), fa.attention_plain(q, k, v, causal=causal,
                                        window=window).float(),
        **TOL["bf16"])
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal,
                                               window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["split", "chunked"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", NORM_SHAPES + [
    (2048, 1024), (4, 1024), (2048, 5120), (4, 2560)])
def test_rmsnorm_kernel_matches_plain_on_card(shape, dt, design,
                                              cuda_device):
    tdt = DTYPES[dt][1]
    x = torch.randn(shape, device=cuda_device).to(tdt)
    s = torch.randn(shape[-1], device=cuda_device)
    got = rn.rmsnorm(x, s, design=design)
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), rn.rmsnorm_plain(x, s).float(),
                               **TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,nh,P,N,chunk", SSD_CASES + [
    (2, 12, 8, 16, 16, 8),       # the mamba2 smoke config's prefill
    (1, 40, 2, 64, 16, 128),     # jamba's (P, N)
])
def test_ssd_kernel_matches_plain_on_card(B, S, nh, P, N, chunk, dt,
                                          cuda_device):
    tdt = DTYPES[dt][1]
    xn, dtn, An, Bn, Cn = (torch.from_numpy(a).to(cuda_device)
                           for a in _ssd_inputs(B, S, nh, P, N))
    x, Bm, Cm = xn.to(tdt), Bn.to(tdt), Cn.to(tdt)
    y, h = ssd.ssd_scan(x, dtn, An, Bm, Cm, chunk=chunk)
    y_p, h_p = ssd.ssd_plain(x, dtn, An, Bm, Cm, chunk=chunk)
    assert y.dtype == tdt and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), **SSD_TOL[dt])
    torch.testing.assert_close(h, h_p, **SSD_H_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 32, 48, 96])
def test_ssd_kernel_chunk_invariance_on_card(chunk, cuda_device):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _ssd_inputs(1, 96, 2, 16, 32, seed=4)]
    y0, h0 = ssd.ssd_plain(*args, chunk=96)
    y, h = ssd.ssd_scan(*args, chunk=chunk)
    torch.testing.assert_close(y, y0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, h0, rtol=2e-4, atol=2e-4)


# every bf16 case of chip_smoke.SSD_CASES at P = 64, then mamba2-2.7b's
# prefill (B=4, S=512, nh=80, N=128)
SSD_TC_CARD_CASES = [
    (1, 128, 1, 64, 128, 128),
    (1, 40, 2, 64, 16, 128),
    (4, 512, 80, 64, 128, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,P,N,chunk", SSD_TC_CARD_CASES)
def test_ssd_tc_kernel_matches_plain_on_card(B, S, nh, P, N, chunk,
                                             cuda_device, monkeypatch):
    """bf16 at P = 64 goes through the tensor-core kernel, matches the plain
    version and gives the same bits twice."""
    monkeypatch.setattr(ssd, "launches_tc", 0)
    monkeypatch.setattr(ssd, "launches_fma", 0)
    xn, dtn, An, Bn, Cn = (torch.from_numpy(a).to(cuda_device)
                           for a in _ssd_inputs(B, S, nh, P, N))
    x, Bm, Cm = xn.bfloat16(), Bn.bfloat16(), Cn.bfloat16()
    y, h = ssd.ssd_scan(x, dtn, An, Bm, Cm, chunk=chunk)
    assert ssd.launches_tc == 1 and ssd.launches_fma == 0
    y_p, h_p = ssd.ssd_plain(x, dtn, An, Bm, Cm, chunk=chunk)
    torch.testing.assert_close(y.float(), y_p.float(), **SSD_TOL["bf16"])
    torch.testing.assert_close(h, h_p, **SSD_H_TOL)
    y2, h2 = ssd.ssd_scan(x, dtn, An, Bm, Cm, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_tc_kernel_chunk_invariance_on_card(chunk, cuda_device):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _ssd_inputs(1, 160, 2, 64, 32, seed=4)]
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16()
    y0, h0 = ssd.ssd_plain(*args, chunk=160)
    y, h = ssd.ssd_scan(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), y0.float(), **SSD_TOL["bf16"])
    torch.testing.assert_close(h, h0, **SSD_H_TOL)

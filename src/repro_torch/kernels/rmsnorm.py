"""RMSNorm on Hopper (Triton), with its plain version.

Replaces the Pallas TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm`` of
``src/repro/kernels/rmsnorm.py``: ``y = x·rsqrt(mean(x²)+eps)·scale`` in
f32, cast back to ``x.dtype``.  RMSNorm is bounded by bytes on the H100:
one read of x and one write of y (2·rows·d·itemsize) for O(d) operations a
row, with the square / mean / rsqrt / scale pipeline in registers so x
crosses device memory once.

Program layout: a grid of a few programs per SM, each looping over rows
``pid, pid + grid, ...`` (short inputs, such as the decode step's 4 rows,
keep one program per row).  Two designs cover a row:

- ``"split"``: with several rows per program, the row as two
  power-of-two blocks, the largest that fits in d and the rest rounded up
  (5120 = 4096 + 1024, 2560 = 2048 + 512, 96 = 64 + 32), so wide rows
  mask no lanes; ``scale`` is loaded once per program and stays in
  registers across its rows; about 16 elements a thread (``num_warps`` =
  largest block / 512).  With one row per program (no more rows than
  SMs, as at decode) latency rules: the row is one masked power-of-two
  block with up to 16 warps, so it takes one reduction, not two.
- ``"chunked"``: the row in chunks of 512, a sum of squares first and the
  scaled write second, whose second read of x must hit L2 to pay.

Rows up to ``SPLIT_MAX_D`` wide take "split"; wider ones take "chunked"
when there are more rows than SMs (as at prefill; at decode one program
per row makes two passes cost latency) and x fits in half of L2 (else
its second read goes to device memory): at each shape the paths run, the
faster of the two as timed on the H100 by ``chip_smoke.py``
(``PERF.md``).

``rmsnorm_plain`` is the same function in plain PyTorch: the CPU path, and
what ``chip_smoke.py`` holds the kernel against on the card.

This module carries no ``from __future__ import annotations``: Triton
reads the ``tl.constexpr`` annotations of the kernels at definition time.
"""
from typing import Optional

import torch

#: launches of the Triton kernels (plain-version calls are not counted)
launches = 0

DESIGNS = ("split", "chunked")
#: widest row of the "split" design when none is asked for
SPLIT_MAX_D = 4096
#: programs per SM of each design's row loop
PROGRAMS_PER_SM = {"split": 8, "chunked": 16}
CHUNK = 512
_DTYPES = (torch.float32, torch.bfloat16)
_KERNELS = {}
_PROPS = {}


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), scale (d,) -> same shape and dtype as x."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def split_blocks(d: int, one_row: bool = False):
    """The two power-of-two blocks of the "split" design: the largest that
    fits in d, and the rest rounded up (0 when d is a power of two); with
    one row per program, d rounded up as one block."""
    if one_row:
        return 1 << (d - 1).bit_length(), 0
    a = 1 << (d.bit_length() - 1)
    rest = d - a
    return a, (1 << (rest - 1).bit_length()) if rest else 0


def _kernels():
    """Define the Triton kernels on first launch (this module must import
    where Triton is missing; ``tl`` becomes a module global so the JIT
    finds it)."""
    global triton, tl
    if not _KERNELS:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_split(x_ptr, s_ptr, o_ptr, rows, d, eps, stride_x,
                          stride_o, BLOCK_A: tl.constexpr,
                          BLOCK_B: tl.constexpr):
            pid = tl.program_id(0)
            step = tl.num_programs(0)
            ca = tl.arange(0, BLOCK_A)
            ma = ca < d             # all true unless the block rounds d up
            sa = tl.load(s_ptr + ca, mask=ma, other=0.0).to(tl.float32)
            if BLOCK_B > 0:
                cb = BLOCK_A + tl.arange(0, BLOCK_B)
                mb = cb < d
                sb = tl.load(s_ptr + cb, mask=mb, other=0.0).to(tl.float32)
            for row in range(pid, rows, step):
                xa = tl.load(x_ptr + row * stride_x + ca, mask=ma,
                             other=0.0).to(tl.float32)
                ss = tl.sum(xa * xa, axis=0)
                if BLOCK_B > 0:
                    xb = tl.load(x_ptr + row * stride_x + cb, mask=mb,
                                 other=0.0).to(tl.float32)
                    ss += tl.sum(xb * xb, axis=0)
                r = tl.rsqrt(ss / d + eps)
                tl.store(o_ptr + row * stride_o + ca,
                         (xa * r * sa).to(o_ptr.dtype.element_ty), mask=ma)
                if BLOCK_B > 0:
                    tl.store(o_ptr + row * stride_o + cb,
                             (xb * r * sb).to(o_ptr.dtype.element_ty),
                             mask=mb)

        @triton.jit
        def rmsnorm_chunked(x_ptr, s_ptr, o_ptr, rows, d, eps, stride_x,
                            stride_o, CHUNK: tl.constexpr):
            pid = tl.program_id(0)
            step = tl.num_programs(0)
            cols = tl.arange(0, CHUNK)
            for row in range(pid, rows, step):
                acc = tl.zeros([CHUNK], dtype=tl.float32)
                for c0 in range(0, d, CHUNK):
                    m = c0 + cols < d
                    x = tl.load(x_ptr + row * stride_x + c0 + cols, mask=m,
                                other=0.0).to(tl.float32)
                    acc += x * x
                r = tl.rsqrt(tl.sum(acc, axis=0) / d + eps)
                for c0 in range(0, d, CHUNK):
                    m = c0 + cols < d
                    x = tl.load(x_ptr + row * stride_x + c0 + cols, mask=m,
                                other=0.0).to(tl.float32)
                    s = tl.load(s_ptr + c0 + cols, mask=m,
                                other=0.0).to(tl.float32)
                    tl.store(o_ptr + row * stride_o + c0 + cols,
                             (x * r * s).to(o_ptr.dtype.element_ty), mask=m)

        _KERNELS.update(split=rmsnorm_split, chunked=rmsnorm_chunked)
    return _KERNELS


def _props(device: torch.device):
    props = _PROPS.get(device.index)
    if props is None:
        props = _PROPS[device.index] = torch.cuda.get_device_properties(
            device)
    return props


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            design: Optional[str] = None) -> torch.Tensor:
    """Launch the Triton kernel (``design`` None: chosen by the row's width
    and the number of rows).  CUDA tensors only: no fallback."""
    global launches
    if not x.is_cuda or not scale.is_cuda or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on "
                         f"{scale.device}; the kernel runs on one CUDA "
                         f"device only")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm: x {x.dtype}, scale {scale.dtype}; want "
                         f"{_DTYPES}")
    d = x.shape[-1]
    if scale.shape != (d,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} must be a "
                         f"contiguous ({d},)")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x is not contiguous")
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    if design is None:
        props = _props(x.device)
        wide = (d > SPLIT_MAX_D and rows > props.multi_processor_count
                and 2 * x.numel() * x.element_size() <= props.L2_cache_size)
        design = "chunked" if wide else "split"
    if design not in DESIGNS:
        raise ValueError(f"rmsnorm: design {design!r} not in {DESIGNS}")
    kernel = _kernels()[design]
    out = torch.empty_like(x2)
    if rows == 0:
        return out.reshape(x.shape)
    n_sm = _props(x.device).multi_processor_count
    grid = (min(rows, PROGRAMS_PER_SM[design] * n_sm),)
    args = (x2, scale, out, rows, d, eps, x2.stride(0), out.stride(0))
    with torch.cuda.device(x.device):
        if design == "split":
            one_row = rows <= n_sm
            a, b = split_blocks(d, one_row)
            warps = max(1, a // 256) if one_row else max(1, a // 512)
            kernel[grid](*args, BLOCK_A=a, BLOCK_B=b,
                         num_warps=min(16 if one_row else 8, warps))
        else:
            chunk = min(CHUNK, triton.next_power_of_2(d))
            kernel[grid](*args, CHUNK=chunk,
                         num_warps=min(4, max(1, chunk // 128)))
    launches += 1
    return out.reshape(x.shape)

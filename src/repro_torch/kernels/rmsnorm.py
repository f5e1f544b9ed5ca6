"""RMSNorm on Hopper (Triton), with its plain version.

Replaces the Pallas TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm`` of
``src/repro/kernels/rmsnorm.py``: ``y = x·rsqrt(mean(x²)+eps)·scale`` in
f32, cast back to ``x.dtype``.  RMSNorm is bounded by bytes on the H100:
one read of x and one write of y (2·rows·d·itemsize) for O(d) operations a
row.  The kernel gives each row one program and the whole row one masked
power-of-two block (so d = 96 or 384 works), keeping the square / mean /
rsqrt / scale pipeline in registers so x crosses device memory once.

``rmsnorm_plain`` is the same function in plain PyTorch: the CPU path, and
what ``chip_smoke.py`` holds the kernel against on the card.

This module carries no ``from __future__ import annotations``: Triton
reads the ``tl.constexpr`` annotation of the kernel at definition time.
"""
import torch

#: launches of the Triton kernel (plain-version calls are not counted)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL = None


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), scale (d,) -> same shape and dtype as x."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _kernel():
    """Define the Triton kernel on first launch (this module must import
    where Triton is missing; ``tl`` becomes a module global so the JIT
    finds it)."""
    global _KERNEL, triton, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, d, eps, stride_x, stride_o,
                           BLOCK: tl.constexpr):
            row = tl.program_id(0)
            cols = tl.arange(0, BLOCK)
            mask = cols < d
            x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / d
            s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = x * tl.rsqrt(var + eps) * s
            tl.store(o_ptr + row * stride_o + cols,
                     y.to(o_ptr.dtype.element_ty), mask=mask)

        _KERNEL = rmsnorm_kernel
    return _KERNEL


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """Launch the Triton kernel.  CUDA tensors only: no fallback."""
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
    kernel = _kernel()
    x2 = x.reshape(-1, d)
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(x2.shape[0],)](x2, scale, out, d, eps, x2.stride(0),
                               out.stride(0), BLOCK=block,
                               num_warps=min(16, max(1, block // 256)))
    launches += 1
    return out.reshape(x.shape)

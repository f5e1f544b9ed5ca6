"""The hand-written kernels as differentiable ops, dispatched by device.

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the kernel, which raises on what it does not take.  There
is no fallback from CUDA to the plain version and no switch that forces
one: a CUDA run either went through the kernel or failed.  A ``meta``
tensor (the dry run's shapes, ``launch/dryrun.py``) raises here: no kernel
runs on it, and the dry run builds its models with ``use_kernels=False``.

Each op is a ``torch.autograd.Function``, the counterpart of the JAX
package's ``custom_vjp`` wrappers (``src/repro/kernels/ops.py``): the
kernel runs forward and saves only its inputs; the backward recomputes the
op's oracle under autograd and differentiates it, as the reference's
backward differentiates its oracle with ``jax.vjp`` (attention:
``ref.attention_ref``; RMSNorm: ``ref.rmsnorm_ref``; SSD: ``ssd_plain``,
the port of ``models/mamba.py:ssd_chunked``).  The reference has no
backward kernel, and neither has the port.  ``causal``, ``window``,
``chunk`` and ``eps`` take no gradient, as in the reference's
``nondiff_argnums``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd


def _oracle_grads(oracle, saved: Sequence[torch.Tensor], outputs_grads
                  ) -> Tuple:
    """Grads of ``oracle(*saved)`` for the inputs, given the grads of its
    outputs (None for an output that takes none)."""
    ins = [t.detach().requires_grad_() for t in saved]
    with torch.enable_grad():
        outs = oracle(*ins)
    if isinstance(outs, torch.Tensor):
        outs = (outs,)
    pairs = [(o, g) for o, g in zip(outs, outputs_grads) if g is not None]
    if not pairs:
        return (None,) * len(ins)
    return torch.autograd.grad([o for o, _ in pairs], ins,
                               [g for _, g in pairs], allow_unused=True)


def _plain(name: str, t: torch.Tensor) -> bool:
    """True on the CPU (the plain version), False on a card (the
    kernel); raises on any other device, the meta device included."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(
        f"{name}: a tensor on {t.device} reaches the kernel op; it runs "
        f"on CUDA tensors (and its plain version on CPU ones) only"
        + (": build the model with use_kernels=False for a meta-device "
           "trace" if t.device.type == "meta" else ""))


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if _plain("attention", q):
            return _fa.attention_plain(q, k, v, causal=causal, window=window)
        return _fa.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        grads = _oracle_grads(
            lambda q, k, v: _ref.attention_ref(q, k, v, causal=ctx.causal,
                                               window=ctx.window),
            ctx.saved_tensors, (g,))
        return (*grads, None, None)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        # an output nobody differentiates (h_final in training) brings None
        ctx.set_materialize_grads(False)
        if _plain("ssd", x):
            return _ssd.ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        grads = _oracle_grads(
            lambda *a: _ssd.ssd_plain(*a, chunk=ctx.chunk),
            ctx.saved_tensors, (gy, gh))
        return (*grads, None)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if _plain("rmsnorm", x):
            return _rn.rmsnorm_plain(x, scale, eps)
        return _rn.rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        grads = _oracle_grads(
            lambda x, s: _ref.rmsnorm_ref(x, s, ctx.eps),
            ctx.saved_tensors, (g,))
        return (*grads, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flash attention.  q (B,Sq,H,hd), k/v (B,Sk,KV,hd).  Differentiable
    (kernel forward, oracle backward)."""
    return _Attention.apply(q, k, v, causal, window)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  x (B,S,nh,P), dt (B,S,nh), A (nh,), Bm/Cm
    (B,S,N) -> y (B,S,nh,P), h_final (B,nh,P,N) f32.  Differentiable in
    both outputs (kernel forward, ``ssd_plain`` backward)."""
    return _SSD.apply(x, dt, A, Bm, Cm, chunk)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), scale (d,) -> same shape and dtype as x.
    Differentiable (kernel forward, oracle backward)."""
    return _RMSNorm.apply(x, scale, eps)

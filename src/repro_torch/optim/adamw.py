"""AdamW with global-norm clipping.

Port of the JAX package's ``optim/adamw.py``: the global gradient norm is
summed over the leaves in the reference's leaf order (sorted dict keys),
the update clips by it, corrects the moments' bias and decays the weights
decoupled from the gradient step, all in f32.

Unlike the reference, which returns new trees, :meth:`AdamW.update`
updates the params and the moments in place (under ``torch.no_grad()``)
and returns the same objects: one copy of the model's state on the card,
not two.  A snapshot is not affected: the capture copies every tensor
before the job resumes.

Across the ranks of a process mesh each rank updates its own blocks;
the clip's norm must be the whole gradient's, so the trainer passes
``grad_sq``, which sums the squares of the blocks this rank holds
replica 0 of and all-reduces the sum.  ``opt/step`` is replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.device_plugin import flatten_with_paths

PyTree = Any


def _zeros_like(tree: PyTree, device=None) -> PyTree:
    if isinstance(tree, dict):
        return {k: _zeros_like(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype,
                       device=tree.device if device is None else device)


@dataclasses.dataclass
class OptState:
    """Flattens to ``step``, ``m/…``, ``v/…`` (the names of the
    reference's registered dataclass); ``step`` is a 0-d int32 tensor, as
    in the reference, so images of both packages agree on its dtype."""
    step: torch.Tensor
    m: PyTree
    v: PyTree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: PyTree) -> OptState:
        device = next(iter(flatten_with_paths(params).values())).device
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=device),
                        m=_zeros_like(params), v=_zeros_like(params))

    def init_abstract(self, params: PyTree) -> OptState:
        """Shape/dtype skeleton on the ``meta`` device (no allocation)."""
        return OptState(step=torch.empty((), dtype=torch.int32,
                                         device="meta"),
                        m=_zeros_like(params, "meta"),
                        v=_zeros_like(params, "meta"))

    @staticmethod
    def grad_sq(g_flat: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The squared global norm: every leaf's sum of squares, in leaf
        order (the reference's)."""
        return sum(torch.sum(torch.square(g.float()))
                   for g in g_flat.values())

    @torch.no_grad()
    def update(self, grads: PyTree, state: OptState, params: PyTree,
               grad_sq: Optional[Callable[[Dict[str, torch.Tensor]],
                                          torch.Tensor]] = None
               ) -> Tuple[PyTree, OptState, Dict[str, torch.Tensor]]:
        """One step, in place: `params`, `state.m`, `state.v` and
        `state.step` are updated and returned.  `grad_sq` computes the
        squared global norm from the flat grads (default
        :meth:`grad_sq`; across ranks, one that all-reduces)."""
        p_flat = flatten_with_paths(params)
        g_flat = flatten_with_paths(grads)
        m_flat = flatten_with_paths(state.m)
        v_flat = flatten_with_paths(state.v)
        if not set(g_flat) == set(m_flat) == set(v_flat) == set(p_flat):
            raise ValueError("grads, moments and params must have the same "
                             "leaves")
        state.step.add_(1)
        step = state.step.to(torch.float32)
        gnorm = torch.sqrt((grad_sq or self.grad_sq)(g_flat))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step
        c2 = 1.0 - b2 ** step
        lr = self.lr(state.step)
        for path, p in p_flat.items():
            g = g_flat[path].float() * scale
            m, v = m_flat[path], v_flat[path]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            step_ = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p32 = p.float()
            p.copy_(p32 - lr * (step_ + self.weight_decay * p32))
        return params, state, {"grad_norm": gnorm, "lr": lr}

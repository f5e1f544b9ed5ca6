"""Input-shape cells and abstract input specs.

Port of the reference's ``launch/shapes.py``: 4 shapes per LM arch;
``decode_*`` / ``long_*`` drive one decode step against a seq_len cache,
``prefill_32k`` the prefill and ``train_4k`` the full train step.
``long_500k`` needs sub-quadratic attention and runs only for the
SSM / hybrid / SWA archs (mamba2, jamba, h2o-danube); the pure
full-attention archs record the cell as skipped.

Abstract inputs are tensors on the ``meta`` device (shape and dtype, no
allocation): the counterpart of ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.policy import ShardingPolicy


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def runs_long_context(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid") or cfg.sub_quadratic


def cells_for(cfg: ModelConfig) -> List[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if runs_long_context(cfg):
        cells.append("long_500k")
    return cells


def skipped_cells_for(cfg: ModelConfig) -> List[Tuple[str, str]]:
    if not runs_long_context(cfg):
        return [("long_500k",
                 "pure full-attention arch: 512k-token decode requires "
                 "sub-quadratic attention (DESIGN.md §4)")]
    return []


# ----------------------------------------------------------------- specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, B: int, S: int,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta-tensor stand-ins for one training / prefill batch."""
    batch: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if cfg.vision_stub:
        batch["vision_embeds"] = _meta((B, cfg.num_patches, cfg.d_model),
                                       dtype)
        batch["loss_mask"] = _meta((B, S), torch.float32)
        batch["positions"] = _meta((3, B, S), torch.int32)
    if cfg.encoder_layers > 0:
        batch["frames"] = _meta((B, cfg.num_audio_frames, cfg.d_model),
                                dtype)
    return batch


def batch_shardings(cfg: ModelConfig, policy: ShardingPolicy, mesh):
    pol = policy.for_mesh(mesh)
    sh = lambda *ax: pol.sharding(mesh, *ax)  # noqa: E731
    out = {"tokens": sh("batch", "seq")}
    if cfg.vision_stub:
        out["vision_embeds"] = sh("batch", None, None)
        out["loss_mask"] = sh("batch", "seq")
        out["positions"] = sh(None, "batch", "seq")
    if cfg.encoder_layers > 0:
        out["frames"] = sh("batch", "frames", None)
    return out


def input_specs(arch_or_cfg, shape: str = "train_4k",
                compute_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Abstract inputs for (arch, shape), no allocation."""
    cfg = arch_or_cfg
    if isinstance(cfg, str):
        from repro_torch.configs import get_config
        cfg = get_config(cfg)
    cell = SHAPES[shape]
    if cell.kind in ("train", "prefill"):
        return batch_specs(cfg, cell.global_batch, cell.seq_len,
                           compute_dtype)
    return {"tokens": _meta((cell.global_batch,), torch.int32),
            "pos": _meta((), torch.int32)}

#!/usr/bin/env python3
"""The device memory that ``chip_smoke.py`` phase 10's path of one arch
should peak at, predicted on the meta device (no card, no weights).

    python3 tools/zoo_train_peaks.py [--arch qwen3-moe-235b-a22b]

At the path's config (``ZOO_TRAIN``: the arch cut to its layers, B x S):
  * the trainer's step: ``repro_torch.launch.dryrun.build_traced`` on a
    (1, 1) meta mesh and ``analyse``, argument bytes (params, AdamW m
    and v, the batch) plus the modelled temp peak;
  * the grad check (``chip_smoke.zoo_grad_check``): the params plus the
    temp peak of two ``loss_and_grads`` passes traced by
    ``launch.hlo_analysis.OpTrace``, the first pass's grad tree live
    while the second runs (the reference tree and one other), in bf16
    and in f32 compute.

Prints both in bytes and GiB, for ``max_memory_allocated`` on the card
to be read against.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def path_config(arch: str) -> tuple:
    """(config cut to the path's layers, B, S) of ``ZOO_TRAIN``'s row."""
    from repro_torch.configs import get_config
    _, layers, B, S, *_ = next(p for p in chip_smoke.ZOO_TRAIN
                               if p[0] == arch)
    return dataclasses.replace(get_config(arch), num_layers=layers), B, S


def trainer_memory(arch: str) -> dict:
    """The dry run's memory record of the path's trainer step on a (1, 1)
    meta mesh: ``argument_size_in_bytes`` and ``temp_size_in_bytes``."""
    from repro_torch.launch.dryrun import analyse, build_traced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeCell
    cfg, B, S = path_config(arch)
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    return analyse(build_traced(cfg, ShapeCell("zoo_train", "train", S, B),
                                mesh), 1)["memory"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b",
                    choices=[p[0] for p in chip_smoke.ZOO_TRAIN])
    args = ap.parse_args()

    import torch
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.launch.hlo_analysis import OpTrace
    from repro_torch.launch.shapes import batch_specs
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import loss_and_grads

    cfg, B, S = path_config(args.arch)
    gib = 2 ** 30
    mem = trainer_memory(args.arch)
    step = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    print(f"[peaks] {cfg.name} ({cfg.num_layers} layers), B {B} x {S}: the "
          f"trainer's step {mem['argument_size_in_bytes']:.0f} B of "
          f"arguments + {mem['temp_size_in_bytes']:.0f} B of temps = "
          f"{step / gib:.2f} GiB")
    params = LM(cfg, device="meta").init_abstract()
    pbytes = sum(t.numel() * t.element_size()
                 for t in flatten_with_paths(params).values())
    batch = batch_specs(cfg, B, S)
    for dtype in (torch.bfloat16, torch.float32):
        model = LM(cfg, compute_dtype=dtype, device="meta")
        trace = OpTrace()
        with trace:
            ref = loss_and_grads(model, params, batch)[1]
            one = trace.peak_temp_bytes
            loss_and_grads(model, params, batch)
        del ref
        peak = pbytes + trace.peak_temp_bytes
        print(f"[peaks] {cfg.name}: the grad check in {str(dtype)[6:]} "
              f"compute: params {pbytes} B + {trace.peak_temp_bytes:.0f} B "
              f"of temps (one pass {one:.0f} B) = {peak / gib:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

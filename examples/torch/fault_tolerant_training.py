"""Fault-tolerant training demo on PyTorch: the full 1000-node failure
story in miniature: periodic and just-in-time snapshots, injected
crashes, automatic restart from the newest valid image, straggler
detection.

    PYTHONPATH=src python examples/torch/fault_tolerant_training.py [RUN_DIR]
    PYTHONPATH=src python examples/torch/fault_tolerant_training.py --device cpu

The counterpart of ``examples/fault_tolerant_training.py`` on
``repro_torch``.  ``--device`` defaults to ``cuda`` and raises without a
card.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import torch

from repro_torch.api import CheckpointOptions
from repro_torch.configs import get_smoke_config
from repro_torch.core.snapshot_io import SnapshotStore
from repro_torch.devices import resolve_device, set_deterministic
from repro_torch.runtime.fault import FailureDetector, StragglerMonitor
from repro_torch.runtime.trainer import (TrainConfig, Trainer,
                                         run_with_restarts)


def main(device="cuda", run_dir=None) -> dict:
    device = resolve_device(device)
    if device.type == "cuda":
        set_deterministic()
    cfg = get_smoke_config("qwen1.5-0.5b")
    run_dir = run_dir or tempfile.mkdtemp(prefix="ft_train_")
    tcfg = TrainConfig(batch_size=4, seq_len=32, total_steps=40,
                       ckpt_every=5,
                       ckpt=CheckpointOptions(mode="async",
                                              incremental=True),
                       compute_dtype=torch.float32, remat=False)

    def make_trainer():
        t = Trainer(cfg, tcfg, run_dir, device=device)
        t.straggler = StragglerMonitor(min_samples=6, threshold=3.0)
        return t

    print("=== training to step 40 with crashes injected at 12 and 27 ===")
    out = run_with_restarts(make_trainer, total_steps=40,
                            failures={12: "node-failure",
                                      27: "node-failure"})
    print(f"steps={out['steps']} restarts={out['restarts']}")
    print(f"loss: {out['loss_history'][0]:.3f} -> "
          f"{out['loss_history'][-1]:.3f}")
    steps = SnapshotStore(run_dir).list_steps()
    print(f"snapshots on disk: {steps}")
    assert out["steps"] == 40 and out["restarts"] == 2

    t = out["trainer"]
    print("=== straggler injection -> just-in-time snapshot ===")
    t.tcfg.ckpt_every = 0                       # periodic off; JIT only
    t.run(10, straggle_at=t.step + 8)
    print(f"JIT snapshots triggered at: {t.jit_ckpt.triggered}")

    print("=== heartbeat failure detector ===")
    fd = FailureDetector(deadline_s=0.2)
    for w in ("pod0/worker0", "pod0/worker1", "pod1/worker0"):
        fd.register(w)
    fd.heartbeat("pod0/worker0")
    fd.heartbeat("pod0/worker1")
    time.sleep(0.25)
    fd.heartbeat("pod0/worker0")
    fd.heartbeat("pod0/worker1")
    dead = fd.dead_workers()
    print(f"dead workers: {dead}  -> restart those from the newest valid "
          f"image")
    print("OK")
    return {"steps": out["steps"], "restarts": out["restarts"],
            "snapshots": steps, "jit_triggered": list(t.jit_ckpt.triggered),
            "final_step": t.step, "dead_workers": dead}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run_dir", nargs="?")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    main(args.device, args.run_dir)

"""Quickstart on PyTorch: transparent unified checkpointing around an
ordinary training loop, the 60-second tour of the port's public API.

    PYTHONPATH=src python examples/torch/quickstart.py [RUN_DIR]
    PYTHONPATH=src python examples/torch/quickstart.py [RUN_DIR] --device cpu

The counterpart of ``examples/quickstart.py`` on ``repro_torch``.  Shows:
(1) the training code contains no checkpoint logic; (2) a unified
snapshot captures device state (params, optimizer) and host state (data
cursor, step counter) in one image; (3) restore is deterministic: the
resumed run produces bitwise-identical losses.  ``--device`` defaults to
``cuda`` and raises without a card.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import torch

from repro_torch.api import CheckpointOptions
from repro_torch.configs import get_smoke_config
from repro_torch.devices import resolve_device, set_deterministic
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(device="cuda", run_dir=None) -> dict:
    device = resolve_device(device)
    if device.type == "cuda":
        set_deterministic()                       # bitwise on the card
    cfg = get_smoke_config("qwen1.5-0.5b")      # reduced Qwen1.5 family
    tcfg = TrainConfig(batch_size=4, seq_len=32, total_steps=30,
                       ckpt_every=10,
                       ckpt=CheckpointOptions(mode="async"),
                       compute_dtype=torch.float32, remat=False)
    run_dir = run_dir or tempfile.mkdtemp(prefix="quickstart_")

    print("=== phase 1: train 20 steps with periodic unified snapshots ===")
    t = Trainer(cfg, tcfg, run_dir, device=device)
    report = t.session.check()                    # `criu check` preflight
    print(f"preflight: ok={report.ok} "
          f"(backend={t.session.backend_name}, "
          f"torch {report.capabilities['torch']['version']})")
    assert report.ok, report.summary()
    out = t.run(20)
    print(f"steps={out['steps']} loss={out['loss']:.4f}")
    snapshots = t.session.store.list_steps()
    print(f"snapshots: {snapshots}")
    ref_losses = t.metrics_history["loss"][10:]   # steps 11..20

    print("=== phase 2: fresh process state, restore, replay 10 steps ===")
    t2 = Trainer(cfg, tcfg, run_dir, device=device)
    step = t2.restore()                            # newest valid image (20)
    print(f"restored at step {step}")
    # rewind demo: restore the *older* snapshot and re-train 11..20
    t3 = Trainer(cfg, tcfg, run_dir, device=device)
    t3.restore(step=10)
    t3.run(10)
    got_losses = t3.metrics_history["loss"][-10:]

    bitwise = all(a == b for a, b in zip(ref_losses, got_losses))
    print(f"deterministic restore: losses bitwise identical = {bitwise}")
    assert bitwise
    print(f"images live in {run_dir}; inspect them offline with:")
    print(f"  python -m repro_torch inspect {run_dir}")
    print("OK")
    return {"steps": out["steps"], "snapshots": snapshots,
            "restored_step": step, "bitwise": bitwise,
            "losses": ref_losses}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run_dir", nargs="?")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    main(args.device, args.run_dir)

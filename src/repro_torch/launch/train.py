"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 200 --ckpt-every 25 --ckpt-mode async [--restore] \\
      [--policy baseline] [--fail-at 120] [--smoke --device cpu]

Port of the reference's ``launch/train.py``: its flags and printed JSON
(plus ``restore_s`` and ``device``), and ``--device`` (default ``cuda``,
which raises without a card).  ``--smoke`` selects the reduced config
(f32 compute); without it the published config trains in bf16 over f32
masters.  On the card the model runs the hand-written kernels.  The
state is laid over ``make_host_mesh(data=1)`` on the device, so images
carry named shardings.  ``--restore`` resumes from the newest valid
image in ``--run-dir`` (the CRIUgpu restart path); ``--fail-at N``
crashes the step loop at step N (exit 1) once the images already
captured are committed.  A crashed run restarted with ``--restore``
reproduces the uninterrupted run bitwise: on the card the launcher sets
the deterministic cuBLAS workspace, deterministic algorithms and TF32
off in its own process (:func:`repro_torch.devices.set_deterministic`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--policy", default="baseline")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-mode", default="async",
                    choices=["sync", "async"])
    ap.add_argument("--incremental", action="store_true")
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--run-dir", default="runs/train")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the newest valid snapshot")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (fault-tolerance demo)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.devices import resolve_device, set_deterministic
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_deterministic()

    import torch

    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.encdec import build_model
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    from repro_torch.sharding import get_policy

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_host_mesh(data=1, device=device)
    compute = torch.float32 if args.smoke else torch.bfloat16
    tcfg = TrainConfig(
        batch_size=args.batch_size, seq_len=args.seq_len, lr=args.lr,
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt=CheckpointOptions(mode=args.ckpt_mode,
                               incremental=args.incremental,
                               keep=args.keep),
        seed=args.seed, compute_dtype=compute)
    model = build_model(cfg, compute_dtype=compute, remat=tcfg.remat,
                        use_kernels=device.type == "cuda", device=device)
    trainer = Trainer(cfg, tcfg, args.run_dir, mesh=mesh,
                      policy=get_policy(args.policy), model=model)
    restore_s = None
    if args.restore:
        t0 = time.perf_counter()
        step = trainer.restore()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0
        print(f"[train] restored unified snapshot at step {step}")
    else:
        trainer.initialize()

    try:
        out = trainer.run(args.steps - trainer.step, fail_at=args.fail_at)
    except Exception as e:
        # the step loop died; images it already captured still commit
        try:
            trainer.session.wait_pending()
        except Exception:                           # noqa: BLE001
            pass
        print(f"[train] crashed: {e} — restart with --restore",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "arch": cfg.name, "steps": out["steps"], "final_loss": out["loss"],
        "wall_s": out["wall_s"],
        "snapshots": trainer.session.store.list_steps(),
        "restore_s": restore_s, "device": str(device),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 200 --ckpt-every 25 --ckpt-mode async [--restore] \\
      [--policy baseline] [--fail-at 120] [--nproc N] \\
      [--smoke --device cpu]

Port of the reference's ``launch/train.py``: its flags and printed JSON
(plus ``restore_s``, ``device``, ``ranks`` and ``per_rank``), and
``--device`` (default ``cuda``, which raises without a card).
``--smoke`` selects the reduced config (f32 compute); without it the
published config trains in bf16 over f32 masters.  On the card the model
runs the hand-written kernels.

As the reference lays the job over every device of the host
(``make_host_mesh(data=len(jax.devices()), model=1)``), the launcher runs
one process per card (:mod:`repro_torch.launch.dist`): ``--nproc``
ranks, by default ``torch.cuda.device_count()`` on ``cuda`` and 1 on the
CPU (``--nproc 2 --device cpu`` runs two gloo ranks here).  The state is
laid over ``make_host_mesh(data=ranks, model=1)`` under ``--policy``:
each rank holds its blocks of the params and the optimizer state, trains
on its rows of the global batch (gathering one super-block's params at a
time: ``per_rank`` reports ``gathered_peak_bytes`` and
``gathered_bytes``), and writes its own pack of each image, which the
two-phase commit makes whole.  Rank 0 prints the JSON.

``--restore`` resumes from the newest image in ``--run-dir`` that every
rank verifies, whatever world size wrote it (the CRIUgpu restart path,
and an elastic one); ``--fail-at N`` crashes the step loop at step N
(exit 1) once the images already captured are committed.  A crashed run
restarted with ``--restore`` at the same world size reproduces the
uninterrupted run bitwise: on the card every rank sets the deterministic
cuBLAS workspace, deterministic algorithms and TF32 off
(:func:`repro_torch.devices.set_deterministic`).  ``--dist-timeout``
bounds every collective and the commit barrier.

``--incremental`` runs across ranks as on one: every rank's pack of an
image dedups against the parent rank 0 chose.  The engine's other modes
(lazy restore, concurrent capture, replication) have no flag here, as
in the reference: they are ``CheckpointOptions``, which a caller hands
to :func:`rank_main`.

:func:`rank_main` is one rank's run; a caller of
:func:`repro_torch.launch.dist.launch` may run it with another model
config, its own ``CheckpointOptions`` or a stalled step, or after
installing a fault on the chaos hook plane
(``launch.dist.KillBeforePrepare``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks, one per card (default: every card of the "
                    "host on cuda, 1 on the CPU)")
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
    ap.add_argument("--dist-timeout", type=float, default=300.0,
                    help="seconds: every collective and the commit barrier")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    from repro_torch.launch import dist
    return dist.launch("repro_torch.launch.train:rank_main", argv,
                       args.nproc, args.device, args.run_dir,
                       args.dist_timeout)


def rank_main(argv, group, *, cfg=None, ckpt=None,
              straggle_at: Optional[int] = None) -> int:
    """One rank's run of the launcher's `argv` in `group`
    (``launch.dist`` has set it up).  `cfg`: the model config (default:
    ``--arch``'s, reduced with ``--smoke``); `ckpt`: the
    ``CheckpointOptions`` (default: those of ``--ckpt-mode``,
    ``--incremental`` and ``--keep``); `straggle_at`: this rank's step
    that stalls (a straggler)."""
    args = _parser().parse_args(argv)
    import torch

    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.encdec import build_model
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    from repro_torch.sharding import get_policy

    rank, world, device = group.rank, group.world, group.device
    if cfg is None:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    mesh = make_host_mesh(data=world, model=1, device=device, group=group)
    compute = torch.float32 if args.smoke else torch.bfloat16
    tcfg = TrainConfig(
        batch_size=args.batch_size, seq_len=args.seq_len, lr=args.lr,
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt=ckpt if ckpt is not None else CheckpointOptions(
            mode=args.ckpt_mode, incremental=args.incremental,
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
        if rank == 0:
            print(f"[train] restored unified snapshot at step {step}")
    else:
        trainer.initialize()

    try:
        out = trainer.run(args.steps - trainer.step, fail_at=args.fail_at,
                          straggle_at=straggle_at)
    except Exception as e:
        # the step loop died; images it already captured still commit
        try:
            trainer.session.wait_pending()
        except Exception:                           # noqa: BLE001
            pass
        print(f"[train] rank {rank} crashed: {e} — restart with --restore",
              file=sys.stderr)
        return 1
    stats = trainer.session.engine.last_stats
    restored = trainer.session.engine.last_restore_stats
    step_s = trainer.metrics_history["step_s"]
    rest = sorted(step_s[1:])
    blocks = flatten_with_paths({"params": trainer.params,
                                 "m": trainer.opt_state.m,
                                 "v": trainer.opt_state.v})
    per_rank = group.gather_objects({
        "rank": rank,
        # this rank's blocks of params and moments, and the device's
        # peak (a step gathers the top-level leaves and one super-block
        # at a time beside them; what the last step gathered: the peak
        # of its live gathered bytes and its bytes gathered, 0 at one
        # rank)
        "block_bytes": sum(t.numel() * t.element_size()
                           for t in blocks.values()),
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        **trainer.gathered,
        # the first step builds and warms the kernels; then the median
        "first_step_ms": 1e3 * step_s[0] if step_s else None,
        "step_ms": 1e3 * rest[len(rest) // 2] if rest else None,
        # the last image's dump (its pack, its pauses, its push)
        "pack_bytes": stats.get("pack_bytes"),
        "barrier_wait_s": stats.get("barrier_wait_s"),
        "dump": {k: stats.get(k) for k in (
            "parent_step", "written_bytes", "reused_bytes", "pin_pause_s",
            "validate_pause_s", "frozen_s", "replicate_s")},
        # the restore (a lazy one's stream time from its join)
        "restore": restored and {k: restored.get(k) for k in (
            "step", "restore_mode", "restore_critical_s",
            "restore_background_s", "critical_bytes", "background_bytes",
            "restored_from_replica")},
        "launches": {"flash_attention": flash_attention.launches,
                     "rmsnorm": rmsnorm.launches,
                     "ssd_scan": ssd_scan.launches}})
    if rank == 0:
        print(json.dumps({
            "arch": cfg.name, "steps": out["steps"],
            "final_loss": out["loss"], "wall_s": out["wall_s"],
            "snapshots": trainer.session.store.list_steps(),
            # the images the straggler monitor asked for, off the period
            "jit_snapshots": trainer.jit_ckpt.triggered,
            "restore_s": restore_s, "device": str(device), "ranks": world,
            "mesh": mesh.shape,
            "per_rank": per_rank,
        }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

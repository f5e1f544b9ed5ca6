"""Serving launcher: batched greedy decode with serving-state snapshots.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --batch 4 --prompt-len 16 --tokens 32 [--snapshot-at 16] [--restore] \\
      [--nproc N] [--smoke --device cpu]

Port of the reference's ``launch/serve.py``: its flags and printed JSON,
plus ``--device`` (default ``cuda``, which raises without a card), the
generated tokens' SHA-256 (``tokens_sha256``) and the run's timings.
``--snapshot-at N`` checkpoints the half-finished generation (KV cache +
cursor) after N tokens; ``--restore`` resumes it in a fresh process — the
serving cold-start story (paper §6).  ``--smoke`` serves the reduced
config in f32; without it the published config serves in bf16 over f32
masters, on the card through the hand-written kernels, with the
deterministic settings of :func:`repro_torch.devices.set_deterministic`.

As the reference serves over every device of the host, the launcher
runs one process per card (:mod:`repro_torch.launch.dist`; ``--nproc``,
by default every card on ``cuda`` and 1 on the CPU): the state is laid
over ``make_host_mesh(data=ranks, model=1)``, each rank serves its rows
of the batch against its block of the KV cache, holding only its
``d_model`` blocks of the params and gathering one layer at a time, and
each writes its own pack of a snapshot.  The batch must divide over the
ranks.  Rank 0 prints the JSON (with ``ranks``; ``per_rank`` reports
what the last prefill or decode step gathered: ``gathered_peak_bytes``,
the peak of its live gathered bytes, and ``gathered_bytes``, 0 at one
rank).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks, one per card (default: every card of the "
                    "host on cuda, 1 on the CPU)")
    ap.add_argument("--dist-timeout", type=float, default=300.0,
                    help="seconds: every collective and the commit barrier")
    ap.add_argument("--policy", default="baseline")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--run-dir", default="runs/serve")
    ap.add_argument("--snapshot-at", type=int, default=None)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    from repro_torch.launch import dist
    return dist.launch("repro_torch.launch.serve:rank_main", argv,
                       args.nproc, args.device, args.run_dir,
                       args.dist_timeout)


def rank_main(argv, group, *, cfg=None) -> int:
    """One rank's run of the launcher's `argv` in `group`
    (``launch.dist`` has set it up).  `cfg`: the model config (default:
    ``--arch``'s, reduced with ``--smoke``)."""
    args = _parser().parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.encdec import build_model
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.sharding import get_policy

    rank, world, device = group.rank, group.world, group.device

    def sync() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    if cfg is None:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    mesh = make_host_mesh(data=world, model=1, device=device, group=group)
    compute = torch.float32 if args.smoke else torch.bfloat16
    model = build_model(cfg, compute_dtype=compute, remat=False,
                        use_kernels=device.type == "cuda", device=device)
    srv = DecodeServer(cfg, args.run_dir, max_seq=args.max_seq,
                       compute_dtype=compute, model=model, mesh=mesh,
                       policy=get_policy(args.policy))
    srv.load(model.init(args.seed))
    timings = {}

    batch = TokenPipeline(cfg, args.batch, args.prompt_len,
                          seed=args.seed).next()
    t0 = sync()
    srv.start(batch)
    timings["prefill_s"] = sync() - t0
    if args.restore:
        t0 = sync()
        pos = srv.restore()
        timings["restore_s"] = sync() - t0
        if rank == 0:
            print(f"[serve] restored mid-generation snapshot at pos {pos}")

    remaining = args.tokens - (srv.pos - args.prompt_len)
    decoded, t_decode = 0, 0.0
    if args.snapshot_at is not None and not args.restore:
        first = min(args.snapshot_at, remaining)
        t0 = sync()
        srv.decode(first)
        t_decode += sync() - t0
        decoded += first
        t0 = time.perf_counter()
        path = srv.checkpoint(0)
        timings["checkpoint_s"] = time.perf_counter() - t0
        st = srv.session.last_stats
        timings["freeze_s"] = st.get("lock_s", 0.0) + st.get("frozen_s", 0.0)
        if rank == 0:
            print(f"[serve] serving snapshot at pos {srv.pos} -> {path}")
        remaining -= first
    t0 = sync()
    srv.decode(max(remaining, 0))
    t_decode += sync() - t0
    decoded += max(remaining, 0)
    if decoded:
        timings["decode_s_per_token"] = t_decode / decoded

    out = srv.tokens
    gen = np.ascontiguousarray(out[:, args.prompt_len:], dtype=np.int32)
    stats = srv.session.engine.last_stats
    per_rank = group.gather_objects({
        "rank": rank, "pack_bytes": stats.get("pack_bytes"),
        "barrier_wait_s": stats.get("barrier_wait_s"), **srv.gathered,
        "launches": {"flash_attention": flash_attention.launches,
                     "rmsnorm": rmsnorm.launches,
                     "ssd_scan": ssd_scan.launches}})
    if rank:
        return 0
    print(json.dumps({
        "arch": cfg.name,
        "generated": int(out.shape[1] - args.prompt_len),
        "tokens_preview": out[0, args.prompt_len:args.prompt_len + 12]
        .tolist(),
        "pos": srv.pos,
        "tokens_sha256": hashlib.sha256(gen.tobytes()).hexdigest(),
        "timings": timings, "device": str(device), "ranks": world,
        "mesh": mesh.shape,
        "per_rank": per_rank,
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``python -m repro_torch`` — operate on snapshot images from outside the
training process (the CRIT analogue), for the PyTorch port.

CRIUgpu images are plain files that CRIT can decode, verify, and edit
without the checkpointed process; schedulers and CI lean on that.  Our
images (``<run_dir>/snapshots/step_*/`` with a MANIFEST.json + pack files,
the JAX package's format) get the same treatment:

  python -m repro_torch check [--run-dir D]        `criu check`: preflight
  python -m repro_torch inspect RUN_DIR [--step N] manifest / size / chain
  python -m repro_torch verify RUN_DIR [--step N]  CRC-verify every entry
  python -m repro_torch gc RUN_DIR --keep N        retire old images
  python -m repro_torch restore RUN_DIR --dry-run  full restore path, host
  python -m repro_torch jobs RUN_DIR [--job ID]    orchestrator job records
  python -m repro_torch orchestrate RUN_DIR        run a preemption scenario
  python -m repro_torch serve-fleet RUN_DIR        K replicas from one image
  python -m repro_torch migrate SRC DST            delta-transfer to a peer
  python -m repro_torch transfer-stats DST         CAS contents + history
                                                   (--fsck --repair)
  python -m repro_torch chaos-campaign RUN_DIR     seeded fault-injection
                                                   campaign over a fleet
  python -m repro_torch trace RUN_DIR --chrome     run journal -> Chrome
                                                   trace JSON (Perfetto)
  python -m repro_torch events RUN_DIR [--job J]   run-journal timeline
  python -m repro_torch metrics RUN_DIR --json     final metrics snapshot

The device rule: the subcommands that run workloads (``orchestrate``,
``serve-fleet``, ``chaos-campaign``) and ``check``'s device probe take
``--device``, ``cuda`` by default; with no card they fail (``--device
cpu`` runs them on the CPU).  The rest only read or move files and run on
the host, as ``restore --dry-run`` does on the host backend.

Exit status is 0 on success, 1 on any problem — scriptable from cron,
GitHub Actions, or a cluster scheduler's health hook.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


# ------------------------------------------------------------------ util
def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def _fmt_time(ts: Optional[float]) -> str:
    if not ts:
        return "-"
    import datetime
    return datetime.datetime.fromtimestamp(ts).strftime("%Y-%m-%d %H:%M:%S")


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    def line(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths))
    out = [line(header), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def _store(run_dir: str):
    from repro_torch.core.snapshot_io import SnapshotStore
    if not os.path.isdir(run_dir):
        raise SystemExit(f"error: {run_dir!r} is not a directory")
    store = SnapshotStore(run_dir)
    if not store.list_steps():
        raise SystemExit(f"error: no snapshots under {run_dir!r} "
                         f"(expected {run_dir}/snapshots/step_*)")
    return store


def _parent_chain(store, step: int, limit: int = 16) -> List[int]:
    """step -> [step, parent, grandparent, ...] (incremental delta chain)."""
    chain = [step]
    seen = {step}
    while len(chain) < limit:
        parent = store.manifest(chain[-1]).get("parent")
        if parent is None or parent in seen:
            break
        chain.append(parent)
        seen.add(parent)
    return chain


# ------------------------------------------------------------------ check
def _device_probe(device: str) -> str:
    """Round-trip a few bytes through `device` (``cuda`` raises without a
    card): what `check` adds to the preflight for the device jobs use."""
    import torch

    from repro_torch.devices import device_kind, resolve_device
    dev = resolve_device(device)
    probe = torch.arange(256, dtype=torch.uint8)
    back = probe.to(dev).cpu()
    if not torch.equal(back, probe):
        raise RuntimeError(f"device probe on {dev}: bytes came back "
                           f"altered")
    return f"{dev} ({device_kind(dev)}) round-trip OK"


def cmd_check(args) -> int:
    from repro_torch.api import check
    report = check(run_dir=args.run_dir)
    probe = _device_probe(args.device)
    if args.json:
        print(json.dumps({"ok": report.ok, "problems": report.problems,
                          "warnings": report.warnings,
                          "device_probe": probe,
                          "capabilities": report.capabilities},
                         indent=2, default=str))
    else:
        caps = report.capabilities
        t = caps["torch"]
        print(report.summary())
        print(f"  torch {t['version']} (cuda build {t['cuda_build']}, "
              f"{t['device_count']} device(s)"
              + (f": {t['device_name']}" if t["device_name"] else "")
              + ")")
        print(f"  device probe: {probe}")
        print(f"  plugin api v{caps['plugin_api_version']}; backends: "
              + ", ".join(f"{n} (v{b['api_version']})"
                          for n, b in caps["backends"].items()))
    return 0 if report.ok else 1


def _print_stripe_layout(store, m) -> None:
    """Chunk/stripe layout of a v2 image: per-stripe file sizes and the
    chunk population of this step's own pack (refs resolved elsewhere)."""
    if m.get("format", 1) < 2:
        return
    from repro_torch.core.snapshot_io import snapshot_dir
    d = snapshot_dir(store.run_dir, m["step"])
    sizes = []
    for name in m.get("files", []):
        p = os.path.join(d, name)
        sizes.append(os.path.getsize(p) if os.path.exists(p) else 0)
    if sizes:
        total = sum(sizes)
        util = min(sizes) / max(sizes) if max(sizes) else 0.0
        print("  stripes:     "
              + "  ".join(f"[{k}] {_fmt_bytes(s)}"
                          for k, s in enumerate(sizes))
              + f"   (total {_fmt_bytes(total)}, balance {util:.2f})")
    try:
        from repro_torch.serialization.pack import open_pack
        base = os.path.join(d, m["files"][0].rsplit(".", 1)[0])
        with open_pack(base, verify=False) as r:
            n_chunks = sum(len(e.get("chunks", []))
                           for e in r.index.values())
            n_ref = sum(1 for e in r.index.values()
                        for c in e.get("chunks", []) if c.get("ref"))
        print(f"  chunks:      {n_chunks} in {len(r.index)} entries"
              + (f" ({n_ref} deduped into parent packs)" if n_ref else ""))
    except Exception:
        pass                      # layout detail is best-effort cosmetics


def _print_restore_schedule(m) -> None:
    """Per-state restore-order breakdown: sizes, chunk counts, and
    priority spans, grouped by state/top-level-subtree — the data an
    operator needs to choose (and audit) the lazy critical set."""
    order = m.get("restore_order") or []
    sizes = m.get("entry_bytes") or {}
    if not order:
        return
    chunk_bytes = m.get("chunk_bytes", 0)
    groups: dict = {}
    for i, name in enumerate(order):
        if name == "__host__":
            key = "(host blobs)"
        else:
            state, path = name.split("::", 1)[0], name.split("::")[1]
            key = f"{state}/{path.split('/')[0]}" if "/" in path else state
        g = groups.setdefault(key, {"entries": 0, "bytes": 0,
                                    "chunks": 0, "lo": i, "hi": i})
        g["entries"] += 1
        nbytes = int(sizes.get(name, 0))
        g["bytes"] += nbytes
        g["chunks"] += (max(1, -(-nbytes // chunk_bytes))
                        if chunk_bytes else 1)
        g["lo"], g["hi"] = min(g["lo"], i), max(g["hi"], i)
    rows = []
    for key, g in sorted(groups.items(), key=lambda kv: kv[1]["lo"]):
        rows.append([key, g["entries"], _fmt_bytes(g["bytes"]),
                     g["chunks"], f"{g['lo']}-{g['hi']}"])
    print("  restore schedule (priority = dump-time registration order;")
    print("  lazy critical set defaults to the first state):")
    for line in _table(rows, ["subtree", "entries", "bytes", "chunks",
                              "priority"]).splitlines():
        print(f"    {line}")


# ---------------------------------------------------------------- inspect
def cmd_inspect(args) -> int:
    store = _store(args.run_dir)
    if args.step is not None:
        m = store.manifest(args.step)
        if args.json:
            print(json.dumps(m, indent=2, default=str))
            return 0
        print(f"snapshot step {m['step']}  ({_fmt_time(m.get('timestamp'))})")
        print(f"  dir:         snapshots/step_{m['step']:08d}")
        print(f"  format:      pack v{m.get('format', 1)}"
              + (f"   chunk: {_fmt_bytes(m['chunk_bytes'])}   "
                 f"stripes: {m.get('stripes', 1)}"
                 if m.get("format", 1) >= 2 else ""))
        print(f"  mode:        {m.get('mode', '-')}   "
              f"incremental: {m.get('incremental', False)}")
        print(f"  capture:     {m.get('capture', 'sync')}")
        cs = m.get("capture_stats") or {}
        if cs:
            print(f"    frozen window: {cs.get('frozen_s', 0.0) * 1e3:.1f} ms"
                  f"  (pin {cs.get('pin_pause_s', 0.0) * 1e3:.1f} ms + "
                  f"validate {cs.get('validate_pause_s', 0.0) * 1e3:.1f} ms); "
                  f"speculated {cs.get('speculate_s', 0.0) * 1e3:.1f} ms "
                  f"unfrozen")
            print(f"    speculated:  {cs.get('speculated_entries', 0)} "
                  f"entries   dirty: {cs.get('dirty_entries', 0)}   "
                  f"re-captured: {cs.get('recaptured_entries', 0)} "
                  f"({_fmt_bytes(cs.get('recaptured_bytes', 0))}, "
                  f"{_fmt_bytes(cs.get('superseded_bytes', 0))} superseded)")
        print(f"  states:      {', '.join(m.get('states', []))}")
        print(f"  written:     {_fmt_bytes(m.get('written_bytes', 0))}   "
              f"reused: {_fmt_bytes(m.get('reused_bytes', 0))}")
        _print_stripe_layout(store, m)
        _print_restore_schedule(m)
        chain = _parent_chain(store, args.step)
        print(f"  parent chain: {' -> '.join(map(str, chain))}")
        topo = m.get("topology") or {}
        if topo:
            print(f"  topology:    {topo.get('n_devices', '?')} device(s), "
                  f"axes {topo.get('mesh_axes')} shape "
                  f"{topo.get('mesh_shape')}")
        entries = m.get("locations", {})
        print(f"  entries:     {len(entries)} "
              f"({sum(1 for v in entries.values() if not v.startswith('step_' + format(m['step'], '08d')))} "
              f"inherited from parents)")
        for w in m.get("warnings", []) or []:
            print(f"  warning:     {w}")
        return 0

    rows = []
    for s in store.list_steps():
        m = store.manifest(s)
        chain = _parent_chain(store, s)
        rows.append([
            s, _fmt_time(m.get("timestamp")), m.get("mode", "-"),
            ",".join(m.get("states", [])),
            _fmt_bytes(m.get("written_bytes", 0)),
            _fmt_bytes(m.get("reused_bytes", 0)),
            " -> ".join(map(str, chain)) if len(chain) > 1 else "-",
        ])
    if args.json:
        hdr = ["step", "time", "mode", "states", "written", "reused",
               "parent_chain"]
        print(json.dumps([dict(zip(hdr, r)) for r in rows], indent=2))
    else:
        print(f"{args.run_dir}: {len(rows)} snapshot(s)")
        print(_table(rows, ["step", "time", "mode", "states", "written",
                            "reused", "parent chain"]))
    return 0


# ----------------------------------------------------------------- verify
def cmd_verify(args) -> int:
    from repro_torch.api.options import auto_io_threads
    store = _store(args.run_dir)
    steps = [args.step] if args.step is not None else store.list_steps()
    bad = 0
    for s in steps:
        try:
            # parallel reader: chunk reads + CRC fan out across stripes
            reader = store.reader(s, verify=True,
                                  io_threads=auto_io_threads())
            try:
                reader.verify_all()
            finally:
                reader.close()
            n = len(store.manifest(s).get("locations", {}))
            print(f"step {s}: OK ({n} entries CRC-verified)")
        except Exception as e:
            bad += 1
            print(f"step {s}: CORRUPT — {e}")
    if bad:
        print(f"{bad}/{len(steps)} snapshot(s) failed verification")
    return 1 if bad else 0


# --------------------------------------------------------------------- gc
def cmd_gc(args) -> int:
    store = _store(args.run_dir)
    steps = store.list_steps()
    if args.keep < 1:
        raise SystemExit("error: --keep must be >= 1")
    if args.dry_run:
        # mirror SnapshotStore.gc's keep-set without deleting: a snapshot
        # survives if kept directly or if any kept manifest still points
        # into its pack files (delta chains reference packs at entry or
        # chunk granularity, not parents)
        keep = set(steps[-args.keep:])
        changed = True
        while changed:
            changed = False
            for s in list(keep):
                for n in store.referenced_steps(store.manifest(s)):
                    if n not in keep:
                        keep.add(n)
                        changed = True
        removable = [s for s in steps if s not in keep]
        print(f"would remove {len(removable)} snapshot(s): {removable}")
        print(f"would keep: {sorted(keep)}")
        return 0
    removed = store.gc(args.keep)
    print(f"removed {len(removed)} snapshot(s): {removed}")
    print(f"remaining: {store.list_steps()}")
    return 0


# ---------------------------------------------------------------- restore
def cmd_restore(args) -> int:
    if not args.dry_run:
        raise SystemExit(
            "error: only --dry-run restores are supported from the CLI; a "
            "real restore needs the owning process (use "
            "repro_torch.api.CheckpointSession.restore there)")
    # Full restore pipeline on the host-numpy backend: manifest selection,
    # CRC verification, entry loading, tree reassembly — everything except
    # device placement.  What `criu restore --check-only` would be.
    from repro_torch.core.engine import SnapshotEngine
    from repro_torch.core.plugins import Plugin

    class _RestoreProbe(Plugin):
        """Observes what the restore pipeline actually loaded."""
        name = "cli-probe"
        host_names: List[str] = []
        step = None

        def restore_ext_state(self, ctx):
            _RestoreProbe.host_names = sorted(ctx.host_state)
            _RestoreProbe.step = ctx.step

    _store(args.run_dir)                              # friendly errors first
    options = None
    if args.lazy:
        from repro_torch.api import CheckpointOptions
        options = CheckpointOptions(
            restore_mode="lazy",
            critical_states=tuple(args.critical) or None)
    eng = SnapshotEngine(args.run_dir, backend="host", options=options)
    eng.add_plugin(_RestoreProbe())
    import time as _time
    t0 = _time.perf_counter()
    restored = eng.restore(step=args.step, verify=True,
                           wait="critical" if args.lazy else None)
    t_resume = _time.perf_counter() - t0
    if args.lazy:
        restored = eng.restore_barrier()
        t_full = _time.perf_counter() - t0
    print(f"step {_RestoreProbe.step}: restore pipeline ran on the "
          f"'host' backend")
    if args.lazy:
        st = eng.last_stats
        print(f"  lazy:        resumed on the critical set in "
              f"{t_resume*1e3:.1f}ms "
              f"({int(st.get('critical_entries', 0))} entries, "
              f"{_fmt_bytes(st.get('critical_bytes', 0))}); "
              f"full materialization {t_full*1e3:.1f}ms "
              f"({int(st.get('background_entries', 0))} background "
              f"entries, {_fmt_bytes(st.get('background_bytes', 0))})")
        print(f"  resume-before-read: job runnable after "
              f"{t_resume/t_full:.0%} of the restore wall")
    host_names = _RestoreProbe.host_names
    total = 0
    rows = []
    import numpy as np
    for state, tree in restored.items():
        leaves = [(k, v) for k, v in _iter_leaves(tree)]
        nbytes = sum(v.nbytes for _, v in leaves
                     if isinstance(v, np.ndarray))
        total += nbytes
        rows.append([state, len(leaves), _fmt_bytes(nbytes)])
    print(_table(rows, ["state", "leaves", "bytes"]))
    print(f"host state present: {host_names}")
    print(f"restore --dry-run OK: {_fmt_bytes(total)} reassembled on the "
          f"host backend (no device placement)")
    return 0


# ------------------------------------------------------------------- jobs
def cmd_jobs(args) -> int:
    """Inspect a cluster's persisted job records without the owning
    process (the `inspect` of the orchestrator plane)."""
    from repro_torch.orchestrator.job import JobState, list_job_records
    recs = list_job_records(args.run_dir)
    if not recs:
        raise SystemExit(f"error: no job records under {args.run_dir!r} "
                         f"(expected {args.run_dir}/jobs/*.json)")
    if args.state is not None:
        try:
            want = JobState(args.state)
        except ValueError:
            raise SystemExit(
                f"error: unknown state {args.state!r} (choose from "
                f"{', '.join(s.value for s in JobState)})")
        recs = [r for r in recs if r.state == want]
    if args.job is not None:
        matching = [r for r in recs if r.spec.job_id == args.job]
        if not matching:
            raise SystemExit(f"error: no job {args.job!r} "
                             f"(have: {[r.spec.job_id for r in recs]})")
        rec = matching[0]
        if args.json:
            print(json.dumps(rec.to_dict(), indent=2, default=str))
            return 0
        print(f"job {rec.spec.job_id}  [{rec.spec.kind}]  "
              f"priority {rec.spec.priority}")
        print(f"  state:       {rec.state.value}")
        print(f"  progress:    step {rec.step}/{rec.spec.total_steps}   "
              f"attempts: {rec.attempt + 1}   restarts: {rec.restarts}")
        print(f"  last ckpt:   "
              f"{'-' if rec.last_ckpt_step is None else rec.last_ckpt_step}")
        for i, b in enumerate(rec.recovery.breakdown()):
            phases = "  ".join(
                f"{k}={b[k]*1e3:.1f}ms" for k in
                ("detect_s", "transfer_s", "schedule_s", "restore_s",
                 "restore_background_s", "replay_s")
                if b[k] is not None)
            print(f"  incident {i}:  {b['cause']}  {phases}"
                  + (f"  replayed={b['steps_replayed']}"
                     if b["steps_replayed"] is not None else "")
                  + (f"  transfer_rounds={len(b['transfer_rounds'])}"
                     if b["transfer_rounds"] else ""))
        for e in rec.events[-8:]:
            desc = (f"{e['from']} -> {e['to']}" if "to" in e
                    else ", ".join(f"{k}={v}" for k, v in e.items()
                                   if k not in ("t", "step")))
            print(f"  event:       t={e['t']:.3f} step={e.get('step', '-')} "
                  f" {desc}")
        return 0

    if args.json:
        # raw values, not display strings — scripts consume this
        print(json.dumps([{
            "job": rec.spec.job_id, "kind": rec.spec.kind,
            "priority": rec.spec.priority, "state": rec.state.value,
            "host": rec.host,
            "step": rec.step, "total_steps": rec.spec.total_steps,
            "restarts": rec.restarts,
            "exhausted": rec.exhausted,
            "incidents": rec.recovery.totals()["incidents"],
            "recovery_s": rec.recovery.totals()["total_s"],
            # per-round migration transfer records (pre-copy rounds +
            # frozen residual); [] for jobs that never moved hosts
            "transfer_rounds": [r for b in rec.recovery.breakdown()
                                for r in b["transfer_rounds"]],
        } for rec in recs], indent=2))
        return 0
    rows = []
    for rec in recs:
        tot = rec.recovery.totals()
        rows.append([
            rec.spec.job_id, rec.spec.kind, rec.spec.priority,
            rec.state.value,
            f"{rec.step}/{rec.spec.total_steps}",
            rec.restarts, tot["incidents"],
            f"{tot['total_s']:.2f}s" if tot["incidents"] else "-",
        ])
    print(f"{args.run_dir}: {len(rows)} job(s)")
    print(_table(rows, ["job", "kind", "prio", "state", "progress",
                        "restarts", "incidents", "recovery"]))
    return 0


# ------------------------------------------------------------ orchestrate
def cmd_orchestrate(args) -> int:
    """Run a deterministic multi-tenant scenario and assert recovery."""
    import contextlib

    from repro_torch.api import CheckpointOptions, TransferPolicy
    from repro_torch.obs.plane import observed
    from repro_torch.orchestrator import run_scenario
    scenario = {"preempt": "preemption"}.get(args.scenario, args.scenario)
    opts = CheckpointOptions(mode=args.mode, pack_format=args.pack_format,
                             io_threads=args.io_threads,
                             incremental=args.incremental)
    policy = None
    if args.max_rounds:
        # live pre-copy migration path: delta rounds while the job steps,
        # freeze only when the residual fits the blackout budget
        policy = TransferPolicy(mode="delta",
                                precopy_rounds=args.max_rounds,
                                max_blackout_ms=args.max_blackout_ms)
    elif args.max_blackout_ms is not None:
        raise SystemExit("error: --max-blackout-ms needs --max-rounds")
    plane = (contextlib.nullcontext() if args.no_trace
             else observed(args.run_dir, detail=args.trace_detail))
    with plane:
        summary = run_scenario(scenario, args.run_dir, options=opts,
                               device=args.device,
                               total_steps=args.steps, kind=args.kind,
                               capacity=args.capacity, hosts=args.hosts,
                               transfer_policy=policy)
    if not args.no_trace:
        jpath = os.path.join(args.run_dir, "obs", "journal.jsonl")
        print(f"run journal -> {jpath} "
              f"(python -m repro_torch trace {args.run_dir} --chrome)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, default=str)
    print(f"scenario {args.scenario!r} ({args.mode} engine, "
          f"capacity {summary['capacity']}, "
          f"{summary.get('hosts', 1)} host(s)): "
          f"{summary['ticks']} ticks, {summary['wall_s']:.2f}s wall, "
          f"cluster goodput {summary['cluster_goodput']:.2f}")
    bad = 0
    for job_id, j in sorted(summary["jobs"].items()):
        ok = j["state"] == "done" and j["step"] == j["total_steps"]
        bad += not ok
        tot = j["recovery_totals"]
        rec = (f"  recovery {tot['total_s']*1e3:.0f}ms over "
               f"{tot['incidents']} incident(s)" if tot["incidents"] else "")
        mig = j.get("migration")
        mig_s = ""
        if mig:
            moved = mig.get("bytes_sent", 0) + mig.get("bytes_copied", 0)
            mig_s = (f"  migrated {mig['from']}->{mig['to']} "
                     f"({_fmt_bytes(moved)} moved, "
                     f"{_fmt_bytes(mig.get('bytes_reused', 0))} deduped)"
                     if mig["state"] == "transferred"
                     else f"  migration {mig['state']}")
            if mig.get("outcome"):
                mig_s += (f"  [pre-copy {mig['outcome']}: "
                          f"{mig.get('rounds_completed', 0)} live "
                          f"round(s), blackout "
                          f"{mig.get('blackout_s', 0.0)*1e3:.1f}ms]")
        print(f"  {job_id:10s} [{j['kind']}] prio {j['priority']}: "
              f"{j['state']} at {j['step']}/{j['total_steps']} "
              f"({j['restarts']} restart(s), goodput {j['goodput']:.2f})"
              + rec + mig_s)
    if bad:
        print(f"error: {bad} job(s) did not recover to completion",
              file=sys.stderr)
    return 1 if bad else 0


# ------------------------------------------------------------ serve-fleet
def cmd_serve_fleet(args) -> int:
    """Boot K decode replicas from one image and serve a bursty trace."""
    import contextlib

    from repro_torch.obs.plane import observed
    from repro_torch.orchestrator.fleet import FleetConfig, run_fleet
    cfg = FleetConfig(replicas=args.replicas, hosts=args.hosts,
                      restore_mode=args.restore_mode, seed=args.seed,
                      max_replicas=max(args.max_replicas, args.replicas))
    trace = None
    if args.trace:
        trace = [int(x) for x in args.trace.split(",")]
    plane = (contextlib.nullcontext() if args.no_trace
             else observed(args.run_dir))
    with plane:
        summary = run_fleet(args.run_dir, cfg, trace=trace,
                            device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, default=str)
    print(f"fleet: {summary['replicas']} replica(s) over "
          f"{len(summary['hosts'])} host(s) from one "
          f"{_fmt_bytes(summary['image_bytes'])} image "
          f"({args.restore_mode} restore)")
    print(f"  restore bytes: {_fmt_bytes(summary['total_restore_bytes'])} "
          f"total = {summary['restore_bytes_vs_image']:.2f}x image "
          f"({_fmt_bytes(summary['restore_bytes_per_replica'])}/replica, "
          f"dedup ratio {summary['dedup_ratio']:.2f})")
    p50, p99 = summary["ttft_p50_s"], summary["ttft_p99_s"]
    if p50 is not None:
        print(f"  TTFT: p50 {p50*1e3:.1f}ms  p99 {p99*1e3:.1f}ms")
    print(f"  served {summary['requests_served']}/"
          f"{summary['requests_arrived']} request(s) in "
          f"{summary['ticks']} tick(s), goodput "
          f"{summary['goodput_requests_per_replica_tick']:.2f} "
          f"req/replica-tick, {summary['autoscale_boots']} autoscale "
          f"boot(s), {summary['drains']} drain(s)")
    for rep in summary["per_replica"]:
        if rep["status"] == "dead":
            print(f"  {rep['rid']} [{rep['host']}] quarantined: "
                  f"{rep['diagnosis']}", file=sys.stderr)
    bad = summary["requests_unserved"] > 0 or summary["dead"] > 0
    if bad:
        print(f"error: {summary['dead']} dead replica(s), "
              f"{summary['requests_unserved']} unserved request(s)",
              file=sys.stderr)
    return 1 if bad else 0


# ---------------------------------------------------------------- migrate
def _verify_dest(dest: str, step: int) -> None:
    # the transferred image must be restorable *now*, while the source
    # still exists — a corrupt target fails here, not at restore time
    from repro_torch.api.options import auto_io_threads
    from repro_torch.core.snapshot_io import SnapshotStore
    reader = SnapshotStore(dest).reader(step, verify=True,
                                        io_threads=auto_io_threads())
    try:
        reader.verify_all()
    finally:
        reader.close()


def _migrate_precopy(args, store, step: int) -> int:
    """Offline pre-copy replay: walk the image's parent chain oldest ->
    newest as live rounds, let the convergence controller pick the freeze
    point, and measure the frozen residual push — the blackout — as the
    final round.  Resumable: the round ledger lives in the target CAS."""
    from repro_torch.api import TransferPolicy
    from repro_torch.transfer import (DeltaReplicator, PrecopyController,
                                summarize_rounds)
    from repro_torch.transfer.delta import transfer_closure
    policy = TransferPolicy(mode="delta", workers=args.workers,
                            precopy_rounds=args.max_rounds,
                            max_blackout_ms=args.max_blackout_ms)
    rep = DeltaReplicator(args.dest, workers=args.workers)
    tag = (f"cli-{os.path.basename(os.path.abspath(args.run_dir))}"
           f"-{step}")
    ctrl = PrecopyController(policy)
    ctrl.seed(rep.round_state(tag))
    chain = transfer_closure(store, step)
    outcome, reason = None, ""
    for s in chain[:-1]:                      # live rounds: the history
        if len(ctrl.rounds) >= policy.precopy_rounds:
            outcome, reason = "fallback", (f"round cap "
                                           f"{policy.precopy_rounds} hit")
            break
        ctrl.observe(rep.push_round(args.run_dir, s, tag))
        d = ctrl.decide()
        if d.action != "continue":
            outcome = "converged" if d.action == "freeze" else "fallback"
            reason = d.reason
            break
    if outcome is None:
        outcome, reason = "converged", "history exhausted"
    # frozen residual: the target step itself — the measured blackout
    resid = rep.push_round(args.run_dir, step, tag, residual=True)
    ledger = rep.round_state(tag)
    _verify_dest(args.dest, step)
    rep.clear_rounds(tag)
    stats = dict(resid)
    stats.update(summarize_rounds(ledger))
    stats["outcome"] = outcome
    stats["reason"] = reason
    stats["rounds"] = ledger
    if args.json:
        print(json.dumps(stats, indent=2, default=str))
        return 0
    print(f"migrated step {step}: {args.run_dir} -> {args.dest} "
          f"(pre-copy, {outcome}: {reason})")
    rows = [[r["round"], r["step"],
             "residual" if r.get("residual") else "live",
             _fmt_bytes(r["bytes_sent"]), _fmt_bytes(r["bytes_reused"]),
             f"{r['wall_s']*1e3:.1f}ms"] for r in ledger]
    print(_table(rows, ["round", "step", "kind", "sent", "deduped",
                        "wall"]))
    print(f"  pre-copied:  {_fmt_bytes(stats['precopy_bytes'])} over "
          f"{stats['rounds_completed']} live round(s)")
    print(f"  blackout:    {stats['blackout_s']*1e3:.1f}ms "
          f"({_fmt_bytes(stats['residual_bytes'])} residual)")
    print(f"  verified:    step {step} CRC-clean at destination")
    return 0


def cmd_migrate(args) -> int:
    """Push snapshot image(s) from a run dir to a peer store, delta or
    full-copy, then prove the transferred image restorable (CRC)."""
    store = _store(args.run_dir)
    step = args.step if args.step is not None else store.latest_step()
    if args.max_rounds and args.transfer != "delta":
        raise SystemExit("error: --max-rounds needs --transfer delta")
    if args.max_blackout_ms is not None and not args.max_rounds:
        raise SystemExit("error: --max-blackout-ms needs --max-rounds")
    if args.max_rounds:
        return _migrate_precopy(args, store, step)
    if args.transfer == "delta":
        from repro_torch.transfer import DeltaReplicator
        rep = DeltaReplicator(args.dest, workers=args.workers)
        stats = rep.push(args.run_dir, step)
    else:
        from repro_torch.core.replication import DirReplicator
        from repro_torch.transfer.delta import transfer_closure
        rep = DirReplicator(args.dest)
        stats = {"bytes_copied": 0, "files_copied": 0, "bytes_skipped": 0,
                 "files_skipped": 0, "step": step}
        for s in transfer_closure(store, step):
            st = rep.push(args.run_dir, s)
            for k in ("bytes_copied", "files_copied",
                      "bytes_skipped", "files_skipped"):
                stats[k] += st[k]
    _verify_dest(args.dest, step)
    if args.json:
        print(json.dumps(stats, indent=2, default=str))
        return 0
    print(f"migrated step {step}: {args.run_dir} -> {args.dest} "
          f"({args.transfer})")
    if args.transfer == "delta":
        moved = stats["bytes_sent"] + stats["bytes_copied"]
        print(f"  sent:        {_fmt_bytes(moved)} in "
              f"{stats['chunks_sent']} chunk(s)"
              + (f" + {stats['files_copied']} v1 file(s)"
                 if stats["files_copied"] else ""))
        print(f"  deduped:     {_fmt_bytes(stats['bytes_reused'])} "
              f"({stats['chunks_reused']} chunk(s) already in the "
              f"target CAS)")
        print(f"  steps:       {stats['steps_transferred']} transferred, "
              f"{stats['steps_skipped']} already present")
        if stats.get("corrupt_objects_healed"):
            print(f"  healed:      {stats['corrupt_objects_healed']} "
                  f"corrupt CAS object(s) re-fetched from source")
        print(f"  wall:        {stats['push_s']*1e3:.1f}ms")
    else:
        print(f"  copied:      {_fmt_bytes(stats['bytes_copied'])} "
              f"({stats['files_copied']} file(s))")
        print(f"  skipped:     {_fmt_bytes(stats['bytes_skipped'])} "
              f"({stats['files_skipped']} unchanged file(s))")
    print(f"  verified:    step {step} CRC-clean at destination")
    return 0


def cmd_transfer_stats(args) -> int:
    """Inspect a peer store's CAS and transfer history offline."""
    from repro_torch.transfer.cas import ChunkStore, default_cas_dir
    cas_dir = default_cas_dir(args.dest)
    if not os.path.isdir(cas_dir):
        raise SystemExit(f"error: no chunk store under {args.dest!r} "
                         f"(expected {cas_dir})")
    store = ChunkStore(cas_dir)
    st = store.stats()
    log = store.transfer_log()
    if args.repair:
        args.fsck = True
    if args.fsck:
        bad = store.fsck(repair=args.repair)
        st["corrupt_objects"] = len(bad)
        if args.repair:
            st["quarantined_objects"] = len(bad)
            st.update(store.stats())       # post-repair object count
    # exit 1 only when corruption is left in place: a --repair run that
    # quarantined everything leaves a clean store behind
    bad_left = st.get("corrupt_objects", 0) if not args.repair else 0
    if args.json:
        print(json.dumps({"cas": st, "transfers": log}, indent=2,
                         default=str))
        return 1 if bad_left else 0
    print(f"{args.dest}: {st['objects']} CAS object(s), "
          f"{_fmt_bytes(st['bytes'])}")
    if st.get("quarantined_objects"):
        print(f"  quarantine:  {st['quarantined_objects']} object(s) "
              f"moved aside this run")
    if args.fsck:
        if not st["corrupt_objects"]:
            print("  fsck:        all objects CRC-clean")
        elif args.repair:
            print(f"  fsck:        {st['corrupt_objects']} corrupt "
                  f"object(s) moved to quarantine/ — the next transfer "
                  f"heals them from source")
        else:
            print(f"  fsck:        {st['corrupt_objects']} corrupt "
                  f"object(s)! (re-run with --repair to quarantine)")
    if log:
        rows = []
        for r in log[-12:]:
            rows.append([
                _fmt_time(r.get("t")), r.get("step", "-"),
                _fmt_bytes(r.get("bytes_sent", 0)
                           + r.get("bytes_copied", 0)),
                _fmt_bytes(r.get("bytes_reused", 0)),
                r.get("steps_transferred", 0),
                f"{r.get('push_s', 0)*1e3:.1f}ms",
            ])
        print(_table(rows, ["time", "step", "sent", "deduped",
                            "steps", "wall"]))
    else:
        print("  (no transfers logged)")
    return 1 if bad_left else 0


# --------------------------------------------------------- chaos-campaign
def cmd_chaos_campaign(args) -> int:
    """Run a seeded fault-injection campaign over a simulated fleet and
    hold it to the survivability invariant: every job recovers bit-exact
    or lands in diagnosable quarantine."""
    import contextlib
    import hashlib

    from repro_torch.chaos import run_campaign
    from repro_torch.chaos.campaign import write_bench_json
    from repro_torch.obs.plane import observed
    modes = (["sync", "concurrent"] if args.capture == "sweep"
             else [args.capture])
    sweep = len(modes) > 1
    reports = {}
    for mode in modes:
        run_dir = os.path.join(args.run_dir, mode) if sweep \
            else args.run_dir
        # one journal per campaign dir: injected faults land as
        # cls="fault" events, so `events RUN --class fault` lines them up
        # against the incident spans they caused
        plane = (contextlib.nullcontext() if args.no_trace
                 else observed(run_dir))
        with plane:
            reports[mode] = run_campaign(
                run_dir, jobs=args.jobs, hosts=args.hosts, seed=args.seed,
                faults=args.faults, max_ticks=args.max_ticks, capture=mode,
                log=lambda m, _mode=mode: print(f"  [{_mode}] {m}"),
                device=args.device)
    for mode in modes:
        print()
        print(reports[mode].table_markdown())
    if sweep:
        # one identity string for the whole sweep: same seed -> both
        # campaigns reproduce -> same combined fingerprint
        combined = hashlib.sha256("\n".join(
            reports[m].fingerprint() for m in modes).encode()).hexdigest()
        print(f"\nfingerprint: {combined}")
    else:
        print(f"\nfingerprint: {reports[modes[0]].fingerprint()}")
    if args.json:
        if sweep:
            # sync metrics keep the historical unprefixed names (so the
            # committed baseline keeps gating them); the concurrent
            # campaign lands under chaos.concurrent.*
            merged = dict(reports["sync"].metrics())
            for k, v in reports["concurrent"].metrics().items():
                merged["chaos.concurrent." + k[len("chaos."):]] = v
            tmp = args.json + ".tmp"
            with open(tmp, "w") as f:
                json.dump(merged, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, args.json)
        else:
            write_bench_json(reports[modes[0]], args.json)
        print(f"bench metrics -> {args.json}")
    if args.report:
        if sweep:
            payload = {"format": 1, "capture": "sweep",
                       "fingerprint": combined,
                       "sync": reports["sync"].to_dict(),
                       "concurrent": reports["concurrent"].to_dict()}
        else:
            payload = reports[modes[0]].to_dict()
        with open(args.report, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        print(f"full report   -> {args.report}")
    violations = 0
    for mode in modes:
        for v in reports[mode].violations:
            violations += 1
            print(f"VIOLATION [{mode}] [{v['reason']}] {v['job']}: "
                  f"{v['detail']}", file=sys.stderr)
    if violations:
        print(f"error: campaign invariant violated "
              f"({violations} violation(s))", file=sys.stderr)
    return 0 if not violations else 1


# ---------------------------------------------------------- observability
def _load_journal_or_die(run_dir: str):
    from repro_torch.obs import export
    from repro_torch.obs.journal import journal_path
    events = export.load_journal(run_dir)
    if not events:
        raise SystemExit(
            f"error: no run journal under {run_dir!r} (expected "
            f"{journal_path(run_dir)}; produced by orchestrate / "
            f"chaos-campaign unless --no-trace)")
    return events


def cmd_trace(args) -> int:
    """Export the run journal as Chrome trace-event JSON (Perfetto)."""
    from repro_torch.obs import export
    events = _load_journal_or_die(args.run_dir)
    problems = export.validate_journal(events)
    if problems:
        for p in problems[:10]:
            print(f"warning: {p}", file=sys.stderr)
    trace = export.to_chrome_trace(
        events, process_name=os.path.basename(args.run_dir.rstrip("/"))
        or "repro_torch")
    out = args.out or os.path.join(args.run_dir, "obs", "trace.json")
    with open(out, "w") as f:
        json.dump(trace, f)
    n_spans = sum(1 for e in events if e.get("kind") == "span")
    print(f"{out}: {len(trace['traceEvents'])} trace event(s), "
          f"{n_spans} span(s) — open in ui.perfetto.dev or "
          f"chrome://tracing")
    return 0


def _event_row(ev) -> List[str]:
    skip = {"v", "cls", "kind", "t", "wall", "name", "ts", "dur",
            "thread", "span_id", "parent_id", "job"}
    if ev.get("kind") == "span":
        t, dur = ev.get("ts", 0.0), ev.get("dur", 0.0)
        what = ev.get("name", "?")
        src = dict(ev.get("attrs") or {})
        job = (ev.get("attrs") or {}).get("job")
    else:
        t, dur = ev.get("t", 0.0), None
        what = f"{ev.get('cls')}/{ev.get('kind')}"
        src = {k: v for k, v in ev.items()}
        job = ev.get("job")
    detail = " ".join(f"{k}={v}" for k, v in sorted(src.items())
                      if k not in skip and v is not None)
    return [f"{t * 1e3:.1f}",
            f"{dur * 1e3:.1f}" if dur is not None else "-",
            ev.get("cls", "?"), what, job or "-", detail[:60]]


def cmd_events(args) -> int:
    """Filtered run-journal timeline (by job and/or event class)."""
    from repro_torch.obs import export
    events = _load_journal_or_die(args.run_dir)
    evs = export.filter_events(events, job=args.job, cls=args.cls)
    if args.json:
        for ev in evs:
            print(json.dumps(ev, default=str))
        return 0
    if not evs:
        print("(no matching events)")
        return 0
    rows = [_event_row(ev) for ev in evs]
    print(_table(rows, ["t_ms", "dur_ms", "class", "event", "job",
                        "detail"]))
    return 0


def cmd_metrics(args) -> int:
    """Final metrics snapshot from the run journal, flat name->value."""
    from repro_torch.obs import export
    events = _load_journal_or_die(args.run_dir)
    metrics = export.metrics_from_journal(events)
    if not metrics:
        raise SystemExit("error: journal holds no metrics snapshot "
                         "(run did not close its observability plane?)")
    if args.json is not None:
        payload = json.dumps(metrics, indent=2, sort_keys=True)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
            print(f"metrics -> {args.json}")
        return 0
    rows = [[k, f"{v:g}" if isinstance(v, (int, float)) else str(v)]
            for k, v in sorted(metrics.items())]
    print(_table(rows, ["metric", "value"]))
    return 0


def _iter_leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _iter_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, node


# ------------------------------------------------------------------- main
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Operate on repro_torch snapshot images (the CRIT "
                    "analogue).")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("check", help="preflight: can checkpointing work "
                       "here? (`criu check`)")
    p.add_argument("--run-dir", default=None,
                   help="also prove this image directory is writable")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device the probe runs on (default cuda; 'cpu' runs "
                        "it on the CPU)")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("inspect", help="list snapshots / show one manifest")
    p.add_argument("run_dir")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("verify", help="CRC-verify image entries")
    p.add_argument("run_dir")
    p.add_argument("--step", type=int, default=None)
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("gc", help="remove old snapshots (parent-chain safe)")
    p.add_argument("run_dir")
    p.add_argument("--keep", type=int, required=True)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=cmd_gc)

    p = sub.add_parser("restore", help="dry-run the restore path on the "
                       "host backend")
    p.add_argument("run_dir")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--lazy", action="store_true",
                   help="priority-ordered lazy restore: time the "
                        "critical-set resume vs full materialization")
    p.add_argument("--critical", action="append", default=[],
                   metavar="STATE[/SUBTREE]",
                   help="critical-set spec (repeatable); default: the "
                        "image's first recorded state")
    p.set_defaults(fn=cmd_restore)

    p = sub.add_parser("jobs", help="inspect orchestrator job records "
                       "(offline, no owning process)")
    p.add_argument("run_dir")
    p.add_argument("--job", default=None, help="show one job in full")
    p.add_argument("--state", default=None, metavar="STATE",
                   help="only jobs in this lifecycle state "
                        "(e.g. failed, done, running)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_jobs)

    p = sub.add_parser("orchestrate", help="run a deterministic "
                       "multi-tenant preemption/failure/migration scenario")
    p.add_argument("run_dir")
    p.add_argument("--scenario", default="mixed",
                   choices=["preemption", "preempt", "failure", "straggler",
                            "migrate", "mixed"])
    p.add_argument("--steps", type=int, default=10,
                   help="steps per low-priority job")
    p.add_argument("--kind", default="train",
                   choices=["train", "serve", "intercept"])
    p.add_argument("--mode", default="async", choices=["sync", "async"])
    p.add_argument("--pack-format", type=int, default=2, choices=[1, 2])
    p.add_argument("--io-threads", type=int, default=0)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--hosts", type=int, default=None,
                   help="simulated hosts (migrate defaults to 2)")
    p.add_argument("--incremental", action="store_true",
                   help="delta images (what the migrate transfer dedups)")
    p.add_argument("--max-rounds", type=int, default=0, metavar="N",
                   help="migrate via live pre-copy: up to N delta rounds "
                        "while the job steps, then a frozen residual")
    p.add_argument("--max-blackout-ms", type=float, default=None,
                   metavar="MS",
                   help="freeze only once the predicted residual push "
                        "fits this budget (needs --max-rounds)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also dump the full summary JSON here")
    p.add_argument("--no-trace", action="store_true",
                   help="skip the observability plane (no run journal)")
    p.add_argument("--trace-detail", action="store_true",
                   help="also record per-chunk spans (pack compress/"
                        "append, lazy entries) — bigger journal")
    p.add_argument("--device", default="cuda",
                   help="device the jobs run on (default cuda; 'cpu' runs "
                        "it on the CPU)")
    p.set_defaults(fn=cmd_orchestrate)

    p = sub.add_parser("serve-fleet", help="boot K decode replicas from "
                       "one committed image (CAS dedup + lazy restore) "
                       "and drive a bursty autoscaling request trace")
    p.add_argument("run_dir")
    p.add_argument("--replicas", type=int, default=8,
                   help="initial fan-out (autoscale may add more)")
    p.add_argument("--hosts", type=int, default=2,
                   help="simulated hosts; one shared CAS each")
    p.add_argument("--restore-mode", default="lazy",
                   choices=["lazy", "eager"],
                   help="lazy = params-critical cold boot (default)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-replicas", type=int, default=64,
                   help="autoscale ceiling")
    p.add_argument("--trace", default=None, metavar="N,N,...",
                   help="arrivals per tick (default: a burst shaped "
                        "to the fleet size)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also dump the full summary JSON here")
    p.add_argument("--no-trace", action="store_true",
                   help="skip the observability plane (no run journal)")
    p.add_argument("--device", default="cuda",
                   help="device the replicas serve on (default cuda; 'cpu' runs "
                        "it on the CPU)")
    p.set_defaults(fn=cmd_serve_fleet)

    p = sub.add_parser("migrate", help="transfer snapshot images to a "
                       "peer store (content-addressed delta by default)")
    p.add_argument("run_dir", help="source run directory")
    p.add_argument("dest", help="destination peer store directory")
    p.add_argument("--step", type=int, default=None,
                   help="snapshot step (default: newest)")
    p.add_argument("--transfer", default="delta",
                   choices=["delta", "copy"])
    p.add_argument("--max-rounds", type=int, default=0, metavar="N",
                   help="pre-copy replay: push the image's parent chain "
                        "as up to N live rounds before the frozen "
                        "residual (delta only)")
    p.add_argument("--max-blackout-ms", type=float, default=None,
                   metavar="MS",
                   help="convergence budget for the pre-copy controller "
                        "(needs --max-rounds)")
    p.add_argument("--workers", type=int, default=0,
                   help="parallel ship lanes (0 = auto)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_migrate)

    p = sub.add_parser("transfer-stats", help="inspect a peer store's "
                       "chunk CAS and transfer history")
    p.add_argument("dest", help="peer store directory (holds .cas/)")
    p.add_argument("--fsck", action="store_true",
                   help="CRC-check every CAS object")
    p.add_argument("--repair", action="store_true",
                   help="with --fsck: move corrupt objects to "
                        "quarantine/ so the next transfer re-fetches "
                        "them from source (implies --fsck)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_transfer_stats)

    p = sub.add_parser("chaos-campaign", help="seeded fault-injection "
                       "campaign: N sim jobs × H hosts must recover "
                       "bit-exact or quarantine diagnosably")
    p.add_argument("run_dir")
    p.add_argument("--jobs", type=int, default=100)
    p.add_argument("--hosts", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--faults", default="all=1", metavar="SPEC",
                   help="fault mix, e.g. 'all=1' or "
                        "'host_kill=3,torn_write=2'")
    p.add_argument("--max-ticks", type=int, default=4000)
    p.add_argument("--capture", choices=("sync", "concurrent", "sweep"),
                   default="sync",
                   help="dump capture mode for the fleet; 'sweep' runs "
                        "both campaigns (sync + concurrent, the latter "
                        "with the dirty_burst class enabled) and merges "
                        "their metrics")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the flat metrics dict here")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="write the full report (rows, outcomes, "
                        "violations, fingerprint) here")
    p.add_argument("--no-trace", action="store_true",
                   help="skip the observability plane (no run journal)")
    p.add_argument("--device", default="cuda",
                   help="device the fleet's job state lives on (default cuda; 'cpu' runs "
                        "it on the CPU)")
    p.set_defaults(fn=cmd_chaos_campaign)

    p = sub.add_parser("trace", help="export a run's journal as Chrome "
                       "trace-event JSON (Perfetto-loadable)")
    p.add_argument("run_dir")
    p.add_argument("--chrome", action="store_true",
                   help="Chrome trace-event JSON (the default and "
                        "currently only format)")
    p.add_argument("-o", "--out", default=None, metavar="PATH",
                   help="output path (default: RUN_DIR/obs/trace.json)")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("events", help="filtered run-journal timeline")
    p.add_argument("run_dir")
    p.add_argument("--job", default=None, help="only this job's events")
    p.add_argument("--class", dest="cls", default=None,
                   choices=["dump", "restore", "transfer", "fault", "job",
                            "recovery", "pack", "orch", "fleet", "metrics"],
                   help="only events of this class")
    p.add_argument("--json", action="store_true",
                   help="one JSON object per line instead of a table")
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser("metrics", help="final metrics snapshot from a "
                       "run's journal (flat name -> value)")
    p.add_argument("run_dir")
    p.add_argument("--json", nargs="?", const="-", default=None,
                   metavar="PATH",
                   help="emit JSON (to PATH, or stdout with no PATH)")
    p.set_defaults(fn=cmd_metrics)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except SystemExit:
        raise
    except KeyboardInterrupt:                          # pragma: no cover
        return 130
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":                             # pragma: no cover
    sys.exit(main())

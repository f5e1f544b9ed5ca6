#!/usr/bin/env python3
"""What the observability plane costs a chaos campaign, timed in turns on
one card.

    python3 tools/chaos_trace_ab.py [--jobs 100] [--hosts 20]   # one GPU

Runs ``chip_smoke.py`` phase 7's campaign (``python -m repro_torch
chaos-campaign RUN --jobs 100 --hosts 20 --seed 0 --faults all=1
--capture sweep``, through ``repro_torch.cli.main`` in this process) with
the run journal and with ``--no-trace``, in the order journal, none,
none, journal, each in a fresh directory, after one warm-up of the card.
Each run's time is the CLI call's wall time; every run must exit 0 and
give the same fingerprint (the journal is a side channel).  Prints one
line per run, the journals' events and bytes, and a JSON summary (the
four times and the cost: the mean with the journal minus the mean
without) with the card's name and power limit.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", type=int, default=100)
    ap.add_argument("--hosts", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chaos_trace_ab: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.chaos.sim import warm_up
    from repro_torch.obs import export
    warm_up("cuda")
    fleet = ["--jobs", str(args.jobs), "--hosts", str(args.hosts),
             "--seed", "0", "--faults", "all=1", "--capture", "sweep"]
    times = {"journal": [], "none": []}
    fingerprints, journal_events, journal_bytes = set(), [], []
    with tempfile.TemporaryDirectory(prefix="chaos_ab_") as workdir:
        for i, traced in enumerate((True, False, False, True)):
            run = os.path.join(workdir, f"run{i}")
            t0 = time.perf_counter()
            rc, out = chip_smoke._cli("chaos-campaign", run, *fleet,
                                      *(() if traced else ("--no-trace",)))
            wall = time.perf_counter() - t0
            if rc:
                raise SystemExit(f"run {i} exited {rc}")
            fingerprints.add(chip_smoke._fingerprint(out))
            kind = "journal" if traced else "none"
            times[kind].append(wall)
            if traced:
                for mode in ("sync", "concurrent"):
                    d = os.path.join(run, mode)
                    journal_events.append(len(export.load_journal(d)))
                    journal_bytes.append(os.path.getsize(
                        os.path.join(d, "obs", "journal.jsonl")))
            print(f"[chaos_ab] sweep, {kind}: {wall:.2f} s", flush=True)
    if len(fingerprints) != 1:
        raise SystemExit(f"the journal changed the fingerprint: "
                         f"{fingerprints}")
    print(f"[chaos_ab] journals (sync, concurrent, per traced run): events "
          f"{journal_events}, bytes {journal_bytes}")
    print(json.dumps(dict(jobs=args.jobs, hosts=args.hosts,
                          journal_s=times["journal"], none_s=times["none"],
                          cost_s=(sum(times["journal"])
                                  - sum(times["none"])) / 2,
                          fingerprint=fingerprints.pop())))
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

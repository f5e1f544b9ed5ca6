"""One process per card: the launchers' ranks.

JAX lays a job over every device of the host from one process
(``make_host_mesh(data=len(jax.devices()))``); in torch one process
drives one device, so the port's counterpart is one process per card
under ``torch.distributed`` (:mod:`repro_torch.distributed`, the group
and its collectives):

  * :func:`launch` runs ``module:function(argv, group)`` in `nproc`
    ranks, by default one per card on ``cuda`` and one on the CPU.  Rank
    0 runs in the caller's process; ranks 1..N-1 are spawned as
    ``python -m repro_torch.launch.dist SPEC``.  Rank ``r`` runs on
    ``cuda:r`` with NCCL, or on the CPU with gloo.  The group meets
    through a file store under the run directory: no TCP port.  With
    several card ranks the kernels are built once before spawning, so
    the ranks do not race to build them into one directory.
  * Every wait has a deadline: the group's timeout bounds each
    collective, the commit barrier has its own (``core/multihost.py``),
    and the launcher joins its ranks with one.  A rank that dies takes
    the others down: rank 0 watches its children and, a grace period
    after one exits non-zero, kills them and exits 1 itself if it has
    not finished; each child exits when rank 0's process is gone.
"""
from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
import uuid
from typing import Any, List, Optional, Sequence

import torch

from repro_torch import distributed
from repro_torch.devices import resolve_device

_JOIN_S = 60.0            # seconds the ranks get to exit after rank 0
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ------------------------------------------------------------ fault demo
class KillBeforePrepare:
    """A fault on the chaos hook plane (``repro_torch.chaos.hooks``): the
    process is killed (SIGKILL) at the ``multihost.prepare`` site of
    `step`, after its pack is written and before its ``PREPARED`` marker
    -- a rank lost in the middle of a commit.  `site`
    ``"replica.prepare"``: after its pack is pushed to the replica and
    before its marker there -- a rank lost in the middle of a push."""

    def __init__(self, step: int, site: str = "multihost.prepare"):
        self.step = int(step)
        self.site = site

    def on(self, site: str, **ctx: Any) -> None:
        if site == self.site and ctx.get("step") == self.step:
            sys.stdout.flush()
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)


# ------------------------------------------------------------ launching
def _call(target: str, argv: Sequence[str],
          group: distributed.Group) -> int:
    module, fn = target.split(":")
    return int(getattr(importlib.import_module(module), fn)(list(argv),
                                                            group) or 0)


class _Watcher(threading.Thread):
    """Rank 0's watch over its children: `grace_s` after one exits
    non-zero, if rank 0 has not finished, kill them all and exit 1."""

    def __init__(self, children: List[subprocess.Popen], grace_s: float):
        super().__init__(daemon=True, name="repro-dist-watch")
        self.children = children
        self.grace_s = grace_s
        self.done = threading.Event()

    def run(self) -> None:
        failed_at = None
        while not self.done.wait(0.2):
            if failed_at is None and any(
                    c.poll() not in (None, 0) for c in self.children):
                failed_at = time.monotonic()
            if failed_at is not None and \
                    time.monotonic() - failed_at > self.grace_s:
                codes = [c.poll() for c in self.children]
                print(f"[dist] a rank died (exit codes {codes}); rank 0 "
                      f"did not finish within {self.grace_s:.0f} s: "
                      f"stopping every rank", file=sys.stderr, flush=True)
                _kill(self.children)
                os._exit(1)


def _kill(children: List[subprocess.Popen]) -> None:
    for c in children:
        if c.poll() is None:
            c.kill()
    for c in children:
        try:
            c.wait(timeout=30)
        except subprocess.TimeoutExpired:       # pragma: no cover
            pass


def launch(target: str, argv: Sequence[str], nproc: Optional[int],
           device: str, run_dir: str,
           timeout_s: float = distributed.DEFAULT_TIMEOUT_S) -> int:
    """``target(argv, group)`` (``"module:function"``, returning an exit
    code) in `nproc` ranks on `device` (``cuda``, the default of the
    launchers, raises without a card; ``cpu``): rank 0 here, the others
    spawned.  `nproc` None: every card on ``cuda``, 1 on the CPU.
    Returns 0 when every rank returned 0, else 1; an exception of rank 0
    is raised once the others are stopped.  The ranks meet through a
    file store under ``run_dir/.dist``."""
    device_type = resolve_device(device).type   # raises without a card
    if nproc is None:
        nproc = torch.cuda.device_count() if device_type == "cuda" else 1
    if nproc < 1:
        raise ValueError(f"nproc must be at least 1, got {nproc}")
    if device_type == "cuda":
        if nproc > torch.cuda.device_count():
            raise RuntimeError(f"{nproc} ranks need {nproc} cards; this "
                               f"host has {torch.cuda.device_count()}")
        if nproc > 1:
            from repro_torch.kernels import build
            build.build_all()                  # once, before the ranks
    store_dir = os.path.join(os.path.abspath(run_dir), ".dist")
    os.makedirs(store_dir, exist_ok=True)
    init_file = os.path.join(store_dir, f"init-{uuid.uuid4().hex}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p)
    children = []
    for r in range(1, nproc):
        spec = {"target": target, "argv": list(argv), "rank": r,
                "world": nproc, "device": device_type,
                "init_file": init_file, "timeout_s": timeout_s,
                "parent": os.getpid()}
        children.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dist",
             json.dumps(spec)], env=env))
    watcher = _Watcher(children, grace_s=2 * timeout_s)
    watcher.start()
    rc = 1
    try:
        group = distributed.init(0, nproc, device_type, init_file,
                                 timeout_s)
        rc = _call(target, argv, group)
    finally:
        watcher.done.set()
        try:
            distributed.shutdown()
        finally:
            # the others end their run once rank 0 has; a failed rank 0
            # leaves them nothing to finish
            deadline = time.monotonic() + (_JOIN_S if rc == 0 else 5.0)
            for c in children:
                try:
                    c.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    pass
            _kill(children)
            try:
                os.remove(init_file)
            except OSError:
                pass
    if any(c.returncode != 0 for c in children):
        print(f"[dist] rank exit codes: "
              f"{[rc] + [c.returncode for c in children]}", file=sys.stderr)
        return 1
    return rc


def _watch_parent(parent: int) -> None:
    while True:
        if os.getppid() != parent:
            os._exit(1)                        # rank 0 is gone
        time.sleep(0.5)


def _rank_main(spec: dict) -> int:
    threading.Thread(target=_watch_parent, args=(spec["parent"],),
                     daemon=True, name="repro-dist-parent").start()
    group = distributed.init(spec["rank"], spec["world"], spec["device"],
                             spec["init_file"], spec["timeout_s"])
    try:
        return _call(spec["target"], spec["argv"], group)
    finally:
        distributed.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        return _rank_main(json.loads(argv[0]))
    except BaseException:                      # noqa: BLE001
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())


"""In-memory / peer-directory snapshot replication (beyond-paper).

Port of the reference's ``core/replication.py``; host code only.

Gemini (SOSP'23) checkpoints to local + *remote host memory* so recovery
does not depend on persistent storage surviving the failure.  Our adaptation
replicates the committed snapshot bytes to a peer store:

  * ``DirReplicator`` — a second directory (standing in for a peer host's
    ramdisk / another node's NVMe); restore falls back to it when the
    primary run_dir has no valid image (tested by corrupting the primary).
  * ``MemReplicator`` — a process-local dict (pure in-memory peer).

Both push after manifest commit (so only *valid* images replicate) and can
re-materialise a snapshot directory into a run_dir on pull.

``DirReplicator`` pushes are O(delta), not O(image): a file already at the
peer with the same size and mtime is skipped (``copy2`` preserves mtime,
so a replica's fingerprint matches its source until the source changes).
Committed snapshots are immutable, so on an incremental chain this turns
re-pushes and shared-parent pushes into metadata stats.  The skip/copy
counters surface in ``last_stats`` (and, via the engine, in
``last_stats["replica_files_skipped"]`` etc. of the dump).

For cross-host transfer that dedups at *chunk* grain against a
content-addressed store, see :class:`repro_torch.transfer.DeltaReplicator` —
same ``push``/``pull_latest`` contract.

The contract itself is the :class:`Replicator` protocol below: engine,
lazy-restore, and migration code dispatch on **capability**
(``supports_rounds``), never on ``isinstance`` of a concrete replicator.
"""
from __future__ import annotations

import os
import shutil
from typing import (Any, Dict, Optional, Protocol, runtime_checkable)

from repro_torch.core.snapshot_io import MANIFEST, SnapshotStore, snapshot_dir


@runtime_checkable
class Replicator(Protocol):
    """What the engine and the migration plane require of a replicator.

    push(run_dir, step)   ship one committed snapshot to the peer; returns
                          a stats dict (implementation-specific counters)
                          or None.
    pull(run_dir, step)   re-materialize one snapshot from the peer over
                          the local copy (the heal path); returns the step
                          or None when the peer has no such image.
    pull_latest(run_dir)  materialize the peer's newest image; returns its
                          step or None.
    stats                 the last push's counters (empty dict before any
                          push).
    supports_rounds       capability flag: True when the replicator can
                          run iterative pre-copy rounds (``push_round`` /
                          ``round_state`` — only content-addressed
                          replicators can diff round i against round i-1).
                          Callers gate migration pre-copy on this instead
                          of ``isinstance(rep, DeltaReplicator)``.
    """

    def push(self, run_dir: str, step: int) -> Optional[Dict[str, Any]]:
        ...

    def pull(self, run_dir: str, step: int) -> Optional[int]:
        ...

    def pull_latest(self, run_dir: str) -> Optional[int]:
        ...

    @property
    def stats(self) -> Dict[str, Any]:
        ...

    @property
    def supports_rounds(self) -> bool:
        ...


def _same_file(src: str, dst: str) -> bool:
    """Unchanged replica fingerprint: same size + same mtime (copy2
    preserves mtime, and committed pack files are never rewritten)."""
    try:
        s, d = os.stat(src), os.stat(dst)
    except OSError:
        return False
    return s.st_size == d.st_size and abs(s.st_mtime - d.st_mtime) < 1e-6


class DirReplicator:
    supports_rounds = False    # whole-file diffing: no per-chunk rounds

    def __init__(self, peer_dir: str):
        self.peer_dir = peer_dir
        os.makedirs(peer_dir, exist_ok=True)
        self.last_stats: Dict[str, Any] = {}

    @property
    def stats(self) -> Dict[str, Any]:
        return self.last_stats

    def push(self, run_dir: str, step: int) -> Dict[str, Any]:
        src = snapshot_dir(run_dir, step)
        dst = snapshot_dir(self.peer_dir, step)
        os.makedirs(dst, exist_ok=True)
        names = sorted(os.listdir(src))
        stats = {"files_copied": 0, "files_skipped": 0,
                 "bytes_copied": 0, "bytes_skipped": 0}
        payload = [n for n in names if n != MANIFEST]
        changed = [n for n in payload + [MANIFEST]
                   if not _same_file(os.path.join(src, n),
                                     os.path.join(dst, n))]
        stale = set(os.listdir(dst)) - set(names)
        if changed or stale:
            # the peer must never hold a committed manifest over payload
            # that is mid-replacement: drop its manifest first, then
            # prune/copy, then re-commit the manifest last
            try:
                os.remove(os.path.join(dst, MANIFEST))
            except OSError:
                pass
            if MANIFEST not in changed:
                changed.append(MANIFEST)   # just unlinked: must re-land
        for n in sorted(stale):
            os.remove(os.path.join(dst, n))
        for n in payload + [MANIFEST]:
            sp, dp = os.path.join(src, n), os.path.join(dst, n)
            if n not in changed:
                stats["files_skipped"] += 1
                stats["bytes_skipped"] += os.path.getsize(sp)
                continue
            tmp = dp + ".tmp"
            shutil.copy2(sp, tmp)          # atomic per file: copy + rename
            os.replace(tmp, dp)
            stats["files_copied"] += 1
            stats["bytes_copied"] += os.path.getsize(sp)
        self.last_stats = stats
        return stats

    def pull(self, run_dir: str, step: int) -> Optional[int]:
        """Re-materialize one snapshot from the peer over the local copy
        — the heal path a lazy background stream uses when it hits a torn
        chunk (the replica pushed at commit time is known-good)."""
        src = snapshot_dir(self.peer_dir, step)
        if not os.path.exists(os.path.join(src, MANIFEST)):
            return None
        dst = snapshot_dir(run_dir, step)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copytree(src, dst)
        return step

    def pull_latest(self, run_dir: str) -> Optional[int]:
        steps = SnapshotStore(self.peer_dir).list_steps()
        if not steps:
            return None
        return self.pull(run_dir, steps[-1])


class MemReplicator:
    supports_rounds = False

    def __init__(self):
        self.images: Dict[int, Dict[str, bytes]] = {}
        self.last_stats: Dict[str, Any] = {}

    @property
    def stats(self) -> Dict[str, Any]:
        return self.last_stats

    def push(self, run_dir: str, step: int) -> None:
        src = snapshot_dir(run_dir, step)
        blob = {}
        for n in os.listdir(src):
            with open(os.path.join(src, n), "rb") as f:
                blob[n] = f.read()
        self.images[step] = blob
        self.last_stats = {"files_copied": len(blob),
                           "bytes_copied": sum(len(b) for b in
                                               blob.values())}

    def pull(self, run_dir: str, step: int) -> Optional[int]:
        if step not in self.images:
            return None
        dst = snapshot_dir(run_dir, step)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        os.makedirs(dst, exist_ok=True)
        blob = self.images[step]
        for n in [n for n in blob if n != MANIFEST] + [MANIFEST]:
            with open(os.path.join(dst, n), "wb") as f:
                f.write(blob[n])
        return step

    def pull_latest(self, run_dir: str) -> Optional[int]:
        if not self.images:
            return None
        return self.pull(run_dir, max(self.images))

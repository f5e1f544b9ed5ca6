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

Across the ranks of a process mesh (the engine calls ``bind_ranks``)
every rank pushes its own pack of each image (``host{rank:04d}.pack*``),
the per-GPU transfer parallelism of the paper, and reports it with a
``PREPARED`` marker in the peer's step directory; once every rank has,
rank 0 lands the manifest, last (:func:`commit_rank_push`, the two-phase
commit of ``core/multihost.py`` on the peer).  A rank lost between its
push and its marker leaves the peer without a manifest for that step.
A pull copies the image with every step it reads from (an incremental
image's parents), so a replica restores after the primary is gone.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    runtime_checkable)

from repro_torch.chaos import hooks as chaos_hooks
from repro_torch.core.snapshot_io import MANIFEST, SnapshotStore, snapshot_dir
from repro_torch.serialization.integrity import read_json


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


@dataclasses.dataclass(frozen=True)
class RankScope:
    """This process's rank of a process mesh, as a replicator pushes."""
    rank: int
    world: int
    timeout_s: float


def rank_files(manifest: Dict[str, Any], rank: int) -> List[str]:
    """The files of `rank`'s pack in an image (its v2 stripes or its v1
    file)."""
    base = f"host{rank:04d}.pack"
    return [n for n in manifest["files"]
            if n == base or n.startswith(base + ".")]


def commit_rank_push(peer_dir: str, step: int, manifest: Dict[str, Any],
                     scope: RankScope, report: Dict[str, Any],
                     land: Callable[[Dict[int, Dict[str, Any]]], None]
                     ) -> Dict[str, Any]:
    """The second half of a push across ranks: this rank's pack is at
    the peer; it prepares with `report` (its push's numbers) under the
    dump's attempt token, then rank 0 waits for every rank's marker and
    calls ``land({rank: report})``, which writes the peer's manifest;
    the other ranks wait for it.  Rank 0 returns the reports merged
    (counts summed, seconds the slowest rank's; with ``per_rank``), the
    others their own."""
    from repro_torch.core.multihost import MultiHostCommit
    b = MultiHostCommit(peer_dir, step, scope.rank, scope.world,
                        deadline_s=scope.timeout_s,
                        attempt=manifest.get("attempt"), poll_s=0.002)
    if chaos_hooks.INJECTOR is not None:
        # chaos: this rank's pack is at the peer, its marker not yet
        chaos_hooks.fire("replica.prepare", step=step, host_id=scope.rank,
                         path=b.dir)
    b.prepare(report)
    if not b.is_coordinator:
        b.wait_committed()
        return report
    out: Dict[str, Any] = {}

    def write() -> str:
        parts = b.prepared_meta()
        land(parts)
        reports = [parts[h] for h in sorted(parts)]
        for k, v in reports[0].items():
            vals = [r.get(k, 0) for r in reports]
            if k == "rank":
                continue
            if k.endswith("_s"):
                out[k] = max(vals)       # the ranks push side by side
            elif (isinstance(v, (int, float)) and not isinstance(v, bool)
                  and k != "step"):
                out[k] = sum(vals)
            else:
                out[k] = v
        out["per_rank"] = reports
        return b.dir
    b.commit(write)
    return out


def copy_atomic(src: str, dst: str) -> None:
    """Copy one file so that `dst` is never seen half written."""
    tmp = dst + ".tmp"
    shutil.copy2(src, tmp)
    os.replace(tmp, dst)


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
        self.ranks: Optional[RankScope] = None

    @property
    def stats(self) -> Dict[str, Any]:
        return self.last_stats

    def bind_ranks(self, rank: int, world: int, timeout_s: float) -> None:
        """Push as `rank` of `world` (see the module docstring)."""
        self.ranks = RankScope(rank, world, timeout_s)

    def push(self, run_dir: str, step: int) -> Dict[str, Any]:
        if self.ranks is not None:
            return self._push_rank(run_dir, step)
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
            copy_atomic(sp, dp)            # atomic per file: copy + rename
            stats["files_copied"] += 1
            stats["bytes_copied"] += os.path.getsize(sp)
        self.last_stats = stats
        return stats

    def _push_rank(self, run_dir: str, step: int) -> Dict[str, Any]:
        """This rank's pack of `step`, then the commit across ranks:
        rank 0 lands the manifest once every rank has pushed."""
        src = snapshot_dir(run_dir, step)
        dst = snapshot_dir(self.peer_dir, step)
        os.makedirs(dst, exist_ok=True)
        manifest = read_json(os.path.join(src, MANIFEST))
        stats = {"files_copied": 0, "files_skipped": 0,
                 "bytes_copied": 0, "bytes_skipped": 0}
        mine = rank_files(manifest, self.ranks.rank)
        changed = [n for n in mine if not _same_file(
            os.path.join(src, n), os.path.join(dst, n))]
        if changed:
            # no committed manifest over payload mid-replacement
            try:
                os.remove(os.path.join(dst, MANIFEST))
            except OSError:
                pass
        for n in mine:
            sp = os.path.join(src, n)
            if n in changed:
                copy_atomic(sp, os.path.join(dst, n))
                stats["files_copied"] += 1
                stats["bytes_copied"] += os.path.getsize(sp)
            else:
                stats["files_skipped"] += 1
                stats["bytes_skipped"] += os.path.getsize(sp)

        def land(parts) -> None:
            copy_atomic(os.path.join(src, MANIFEST),
                        os.path.join(dst, MANIFEST))
        self.last_stats = commit_rank_push(self.peer_dir, step, manifest,
                                           self.ranks, stats, land)
        return self.last_stats

    def pull(self, run_dir: str, step: int) -> Optional[int]:
        """Re-materialize one snapshot from the peer over the local copy,
        with every step it reads from — the heal path a lazy background
        stream uses when it hits a torn chunk (the replica pushed at
        commit time is known-good), and the restore after the primary is
        lost (an incremental image's parents went with it)."""
        from repro_torch.transfer.delta import transfer_closure
        if not os.path.exists(os.path.join(snapshot_dir(self.peer_dir,
                                                        step), MANIFEST)):
            return None
        for s in transfer_closure(SnapshotStore(self.peer_dir), step):
            dst = snapshot_dir(run_dir, s)
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copytree(snapshot_dir(self.peer_dir, s), dst)
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

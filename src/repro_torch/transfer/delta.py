"""DeltaReplicator — ship only the chunks the target doesn't have.

Port of the reference's ``transfer/delta.py``; host code only.

The copy-everything :class:`repro_torch.core.replication.DirReplicator` moves
O(image) bytes per push.  This replicator upgrades the same ``push`` /
``pull_latest`` contract into a three-phase delta protocol against the
target host's :class:`~repro_torch.transfer.cas.ChunkStore`:

  1. **closure** — an incremental snapshot references parent packs (entry
     locations and chunk-level ``ref``\\ s), so the unit of transfer is the
     delta-chain closure, oldest step first;
  2. **negotiate** — for each v2 pack, the chunk index is exported and the
     target answers have/want by CAS key (the raw-CRC content hash pack v2
     already computes); only *wanted* chunks ship, read stripe-parallel
     from the source and landed as CAS objects (the CAS is also the resume
     log: a retried transfer re-negotiates and skips everything received);
  3. **materialize** — stripes are rebuilt byte-identically from the CAS
     (:func:`repro_torch.serialization.pack.write_pack_v2_from_chunks`), the
     manifest is copied last, so the target only ever sees committed,
     restorable images.  A corrupt CAS object is detected by its CRC
     during materialization and healed from the source.

v1 single-file packs have no chunk index — they fall back to whole-file
copy (counted in ``bytes_copied``), so mixed v1/v2 chains still transfer.

Across the ranks of a process mesh (``bind_ranks``) each rank negotiates,
ships and materializes its own pack of each step of the closure, and
rank 0 lands each step's manifest once every rank has
(``core.replication.commit_rank_push``).  Rank 0 alone writes the CAS's
records, from the per-rank numbers the markers carry: one
``transfers.json`` record per rank's push, and one round record (the
ranks' numbers summed) per pre-copy round.
"""
from __future__ import annotations

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from repro_torch.core.replication import (RankScope, commit_rank_push,
                                          rank_files)
from repro_torch.core.snapshot_io import (MANIFEST, SnapshotStore,
                                          auto_io_threads, snapshot_dir)
from repro_torch.obs import journal as obs_journal
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serialization.integrity import atomic_write_json, read_json
from repro_torch.serialization.pack import (PackReaderV2, open_pack,
                                            write_pack_v2_from_chunks)
from repro_torch.transfer.cas import (CASCorruption, ChunkStore, chunk_key,
                                      default_cas_dir)


def transfer_closure(store: SnapshotStore, step: int) -> List[int]:
    """Every step whose packs `step`'s image reads from, transitively,
    oldest first — the unit of a cross-host transfer."""
    need = [step]
    seen = {step}
    i = 0
    while i < len(need):
        for ref in store.referenced_steps(store.manifest(need[i])):
            if ref not in seen:
                seen.add(ref)
                need.append(ref)
        i += 1
    return sorted(need)


def _fresh_stats() -> Dict[str, Any]:
    return {"bytes_sent": 0, "bytes_reused": 0, "bytes_copied": 0,
            "chunks_sent": 0, "chunks_reused": 0, "files_copied": 0,
            "steps_transferred": 0, "steps_skipped": 0,
            "corrupt_objects_healed": 0, "push_s": 0.0}


class DeltaReplicator:
    """Content-addressed replication into a peer snapshot store.

    Drop-in for :class:`DirReplicator` (same ``push``/``pull_latest``
    surface, same peer-directory layout), so
    ``TransferPolicy(mode="delta")`` swaps the data path without touching
    the engine's commit ordering.  ``supports_rounds`` advertises the
    extra pre-copy surface (:meth:`push_round` / :meth:`round_state`)
    that content-addressing makes possible — callers discover it through
    the :class:`repro_torch.core.replication.Replicator` protocol, never via
    isinstance.
    """

    supports_rounds = True

    def __init__(self, peer_dir: str, cas_dir: Optional[str] = None,
                 workers: int = 0):
        self.peer_dir = peer_dir
        os.makedirs(peer_dir, exist_ok=True)
        self.store = ChunkStore(cas_dir or default_cas_dir(peer_dir))
        if workers <= 0:
            workers = auto_io_threads()
        self.workers = workers
        self.last_stats: Dict[str, Any] = _fresh_stats()
        self.ranks: Optional[RankScope] = None

    @property
    def stats(self) -> Dict[str, Any]:
        return self.last_stats

    def bind_ranks(self, rank: int, world: int, timeout_s: float) -> None:
        """Push as `rank` of `world` (see the module docstring)."""
        self.ranks = RankScope(rank, world, timeout_s)

    # -------------------------------------------------------------- push
    def push(self, run_dir: str, step: int) -> Dict[str, Any]:
        """Transfer `step`'s delta-chain closure from `run_dir` into the
        peer store; returns (and records) the transfer stats."""
        t0 = time.perf_counter()
        stats = _fresh_stats()
        src = SnapshotStore(run_dir)
        closure = transfer_closure(src, step)
        with obs_trace.span("transfer.push", step=step) as sp:
            for s in closure:
                # across ranks the commit of the push's own step carries
                # this rank's numbers for the whole push
                stats = self._push_step(run_dir, s, stats,
                                        s == closure[-1], t0)
            sp.set(bytes_sent=stats["bytes_sent"],
                   chunks_sent=stats["chunks_sent"],
                   chunks_reused=stats["chunks_reused"])
        stats["push_s"] = time.perf_counter() - t0
        stats["step"] = step
        stats["source"] = os.path.abspath(run_dir)
        self.last_stats = stats
        if self.ranks is None:
            self.store.log_transfer(stats)
        for k in ("bytes_sent", "bytes_reused", "chunks_sent",
                  "chunks_reused", "corrupt_objects_healed"):
            obs_metrics.counter_add(f"transfer.{k}", stats[k])
        obs_journal.emit("transfer", "push", step=step,
                         bytes_sent=stats["bytes_sent"],
                         bytes_reused=stats["bytes_reused"],
                         chunks_sent=stats["chunks_sent"],
                         chunks_reused=stats["chunks_reused"],
                         push_s=stats["push_s"])
        return stats

    # ------------------------------------------------------ pre-copy rounds
    def push_round(self, run_dir: str, step: int, tag: str,
                   residual: bool = False) -> Dict[str, Any]:
        """One pre-copy round: push `step`'s closure, then append the
        round's byte/wall record to the CAS-side ledger keyed by `tag`.

        The round's *delta* falls out of the ordinary push protocol —
        chunks whose raw-CRC content hashes already landed in a previous
        round negotiate away as ``chunks_reused``, whole steps already
        committed on the target skip as ``steps_skipped`` — so round i
        ships exactly what changed since round i-1.  The ledger lives in
        the destination CAS (`round_state`), making an interrupted
        migration resumable from the target's own record.
        """
        round_idx = len(self.store.round_state(tag))
        with obs_trace.span("transfer.round", round=round_idx, step=step,
                            residual=residual) as sp:
            stats = self.push(run_dir, step)
            sp.set(bytes_sent=stats["bytes_sent"],
                   bytes_reused=stats["bytes_reused"],
                   chunks_sent=stats["chunks_sent"])
        record = {"round": round_idx, "step": step, "residual": residual,
                  "bytes_sent": stats["bytes_sent"],
                  "bytes_reused": stats["bytes_reused"],
                  "chunks_sent": stats["chunks_sent"],
                  "chunks_reused": stats["chunks_reused"],
                  "wall_s": stats["push_s"]}
        if self.ranks is None or self.ranks.rank == 0:
            # across ranks rank 0's push returned the ranks' sum
            self.store.append_round(tag, record)
        obs_metrics.counter_add("transfer.round_bytes",
                                stats["bytes_sent"])
        if residual:
            obs_metrics.counter_add("transfer.residual_bytes",
                                    stats["bytes_sent"])
        obs_journal.emit("transfer", "round", tag=tag, round=round_idx,
                         step=step, residual=residual,
                         bytes_sent=stats["bytes_sent"],
                         wall_s=stats["push_s"])
        return record

    def round_state(self, tag: str) -> List[Dict[str, Any]]:
        """The CAS-persisted round ledger for one migration tag."""
        return self.store.round_state(tag)

    def clear_rounds(self, tag: str) -> None:
        self.store.clear_rounds(tag)

    def _push_step(self, run_dir: str, step: int,
                   stats: Dict[str, Any], last: bool = False,
                   t0: float = 0.0) -> Dict[str, Any]:
        """One step of the closure; across ranks, this rank's pack and
        the step's commit (`last`: the push's own step, whose commit
        gathers the ranks' numbers and logs them).  Returns the stats
        (rank 0's, at the last step across ranks: summed over ranks)."""
        src_dir = snapshot_dir(run_dir, step)
        dst_dir = snapshot_dir(self.peer_dir, step)
        manifest = read_json(os.path.join(src_dir, MANIFEST))
        dst_manifest = os.path.join(dst_dir, MANIFEST)
        done = False
        if os.path.exists(dst_manifest):
            try:
                done = read_json(dst_manifest) == manifest
            except Exception:
                pass                       # torn target manifest: redo
        if done:
            stats["steps_skipped"] += 1
            if self.ranks is None or not last:
                return stats               # already transferred + committed
        os.makedirs(dst_dir, exist_ok=True)
        # group physical files into pack bases: "host0000.pack.0" and
        # siblings are one v2 pack; a bare "host0000.pack" is v1
        names = manifest.get("files")
        if not names:                      # pre-"files" manifest: scan disk
            names = sorted(n for n in os.listdir(src_dir) if n != MANIFEST)
        if self.ranks is not None:
            names = [] if done else rank_files(manifest, self.ranks.rank)
        bases: Dict[str, bool] = {}
        for name in names:
            if name.rsplit(".", 1)[-1].isdigit():
                bases[name.rsplit(".", 1)[0]] = True      # v2 stripe set
            else:
                bases[name] = False                       # v1 single file
        for base, is_v2 in sorted(bases.items()):
            if is_v2:
                self._push_pack_v2(os.path.join(src_dir, base),
                                   os.path.join(dst_dir, base), stats)
            else:
                self._copy_file(os.path.join(src_dir, base),
                                os.path.join(dst_dir, base), stats)
        if not done:
            stats["steps_transferred"] += 1
        if self.ranks is None:
            # manifest last: commit ordering preserved across the wire
            atomic_write_json(dst_manifest, manifest)
            return stats

        def land(parts) -> None:
            atomic_write_json(dst_manifest, manifest)
            if last:
                self.store.log_transfers([parts[h] for h in sorted(parts)])
        if not last:
            commit_rank_push(self.peer_dir, step, manifest, self.ranks, {},
                             land)
            return stats
        stats.update(push_s=time.perf_counter() - t0, step=step,
                     source=os.path.abspath(run_dir), rank=self.ranks.rank)
        return commit_rank_push(self.peer_dir, step, manifest, self.ranks,
                                dict(stats), land)

    def _copy_file(self, src: str, dst: str, stats: Dict[str, Any]) -> None:
        """v1 fallback: no chunk index to negotiate over — full copy."""
        tmp = dst + ".tmp"
        shutil.copy2(src, tmp)
        os.replace(tmp, dst)
        stats["files_copied"] += 1
        stats["bytes_copied"] += os.path.getsize(src)

    def _push_pack_v2(self, src_base: str, dst_base: str,
                      stats: Dict[str, Any]) -> None:
        reader = open_pack(src_base, verify=False)
        if not isinstance(reader, PackReaderV2):       # sniffed as v1
            reader.close()
            self._copy_file(src_base, dst_base, stats)
            return
        with reader:
            with obs_trace.span("transfer.negotiate") as sp:
                chunks = [c for _n, _j, c in reader.own_chunks()]
                keys = [chunk_key(c) for c in chunks]
                have = self.store.have(keys)           # negotiate
                want = [c for c, k in zip(chunks, keys) if k not in have]
                sp.set(chunks=len(chunks), have=len(have),
                       want=len(want))
            for c, k in zip(chunks, keys):
                if k in have:
                    stats["chunks_reused"] += 1
                    stats["bytes_reused"] += c["nbytes"]
            with obs_trace.span("transfer.ship", chunks=len(want)):
                self._ship(reader, want, stats)        # striped + parallel
            footer = {"format": 2, "stripes": reader.stripes,
                      "chunk_bytes": reader.chunk_bytes,
                      "entries": reader.index}
            with obs_trace.span("transfer.materialize"):
                write_pack_v2_from_chunks(
                    dst_base, footer,
                    fetch=lambda c: self._fetch(reader, c, stats))

    def _ship(self, reader: PackReaderV2, want: List[Dict[str, Any]],
              stats: Dict[str, Any]) -> None:
        """Move wanted chunks source→CAS, one worker per stripe lane so
        each lane reads its stripe file sequentially (the same
        parallelism shape as the pack writer's stripe appenders)."""
        if not want:
            return
        lanes: Dict[int, List[Dict[str, Any]]] = {}
        for c in want:
            lanes.setdefault(c["stripe"], []).append(c)

        def ship_lane(lane: List[Dict[str, Any]]) -> int:
            n = 0
            for c in sorted(lane, key=lambda c: c["offset"]):
                self.store.put(chunk_key(c), reader.read_stored_chunk(c))
                n += c["nbytes"]
            return n

        if len(lanes) > 1 and self.workers > 1:
            with ThreadPoolExecutor(
                    max_workers=min(self.workers, len(lanes)),
                    thread_name_prefix="repro-transfer") as ex:
                sent = list(ex.map(ship_lane, lanes.values()))
        else:
            sent = [ship_lane(lane) for lane in lanes.values()]
        stats["bytes_sent"] += sum(sent)
        stats["chunks_sent"] += len(want)

    def _fetch(self, reader: PackReaderV2, c: Dict[str, Any],
               stats: Dict[str, Any]) -> bytes:
        """Materialization chunk source: the CAS, with source-side healing
        when an object fails its CRC (detected *before* any restore)."""
        key = chunk_key(c)
        try:
            return self.store.get(key)
        except (CASCorruption, KeyError):
            # corrupt on disk (CRC mismatch) or missing outright (e.g.
            # quarantined by fsck --repair): both heal from the source
            self.store.drop(key)
            data = reader.read_stored_chunk(c)
            self.store.put(key, data)
            stats["corrupt_objects_healed"] += 1
            stats["bytes_sent"] += c["nbytes"]
            return data

    # -------------------------------------------------------------- pull
    def pull(self, run_dir: str, step: int) -> Optional[int]:
        """Re-materialize one snapshot (plus its delta-chain closure)
        from the peer over the local copy — the heal path for a torn
        chunk caught by a lazy background stream."""
        peer = SnapshotStore(self.peer_dir)
        if step not in peer.list_steps():
            return None
        for s in transfer_closure(peer, step):
            src = snapshot_dir(self.peer_dir, s)
            dst = snapshot_dir(run_dir, s)
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copytree(src, dst)
        return step

    def pull_latest(self, run_dir: str) -> Optional[int]:
        """Materialize the newest peer snapshot into `run_dir` (the
        restore-side fallback the engine uses when the primary store has
        no valid image) — same contract as DirReplicator."""
        steps = SnapshotStore(self.peer_dir).list_steps()
        if not steps:
            return None
        return self.pull(run_dir, steps[-1])

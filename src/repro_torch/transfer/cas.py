"""Content-addressed chunk store (CAS) — the target side of delta transfer.

Port of the reference's ``transfer/cas.py``; host code only.

Every pack-v2 chunk already carries a ``raw_crc32`` content hash (computed
over the uncompressed bytes; it drives incremental chunk dedup).  The CAS
keys objects by that hash, qualified by the raw length and the stored-byte
CRC so a hit guarantees *byte-identical* re-materialization of the stripe
file::

    <root>/objects/<kk>/<raw_crc32>-<raw_nbytes>-<stored_crc32>

Objects hold the *stored* (possibly compressed) chunk bytes: transfer
never pays a recompression, and materialized packs reproduce the source
layout exactly (incremental ``ref`` offsets keep resolving).

Properties the transfer layer leans on:

  * idempotent ``put`` (tmp + atomic rename) — an interrupted transfer
    resumes by re-negotiating have/want; received chunks are never re-sent;
  * verifying ``get`` — a corrupt object raises :class:`CASCorruption`
    *before* any restore can read the bad bytes; the replicator heals it
    from the source while it still has one.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Set

from repro_torch.chaos import hooks as chaos_hooks
from repro_torch.serialization.integrity import crc32

TRANSFER_LOG = "transfers.json"
QUARANTINE_DIR = "quarantine"
ROUNDS_DIR = "rounds"


class CASCorruption(IOError):
    """A CAS object's bytes no longer match its content-hash key."""


def chunk_key(c: Dict[str, Any]) -> str:
    """CAS key of one pack-v2 chunk record.

    Primary key is the raw-CRC content hash the pack already computed;
    raw length and stored CRC qualify it so that (a) the 32-bit hash
    cannot silently alias across different-sized chunks and (b) a hit
    can be spliced into a rebuilt stripe byte-for-byte.
    """
    return f"{c['raw_crc32']:08x}-{c['raw_nbytes']:x}-{c['crc32']:08x}"


def _stored_crc_of(key: str) -> int:
    return int(key.rsplit("-", 1)[1], 16)


class ChunkStore:
    """One directory of content-addressed chunk objects."""

    def __init__(self, root: str):
        self.root = root
        self.objects = os.path.join(root, "objects")
        os.makedirs(self.objects, exist_ok=True)

    # ------------------------------------------------------------ lookup
    def path(self, key: str) -> str:
        return os.path.join(self.objects, key[:2], key)

    def has(self, key: str) -> bool:
        return os.path.exists(self.path(key))

    def have(self, keys: Iterable[str]) -> Set[str]:
        """The have/want negotiation: which of `keys` are already here."""
        return {k for k in keys if self.has(k)}

    # ------------------------------------------------------------ mutate
    def put(self, key: str, data: bytes) -> bool:
        """Store one chunk; returns False if it was already present.
        The stored-CRC qualifier in the key is verified on the way in,
        so a corrupted wire payload never lands.  Concurrency-safe for
        same-key racers (stripe lanes ship duplicate-content chunks):
        each writer uses its own tmp file and the atomic `os.replace`
        makes the last one win — both wrote identical bytes."""
        if chaos_hooks.INJECTOR is not None:
            # chaos: network-partition site — a handler may raise here to
            # model the host losing its route to the CAS mid-push
            chaos_hooks.fire("cas.put", key=key, nbytes=len(data))
        if crc32(data) != _stored_crc_of(key):
            raise CASCorruption(
                f"cas put {key}: payload CRC does not match the key "
                f"(corrupted in transit?)")
        dst = self.path(key)
        if os.path.exists(dst):
            return False
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dst)
        if chaos_hooks.INJECTOR is not None:
            # chaos: bit-rot site — a handler may corrupt the object that
            # just landed; the verifying get/materialize must catch it
            chaos_hooks.fire("cas.landed", key=key, path=dst)
        return True

    def get(self, key: str) -> bytes:
        """Read one chunk, CRC-verified against its key — a bit-rotted
        object is detected here, before any restore consumes it."""
        try:
            with open(self.path(key), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise KeyError(f"cas object {key} not found under {self.root}")
        if crc32(data) != _stored_crc_of(key):
            raise CASCorruption(
                f"cas object {key} is corrupt on disk "
                f"({self.path(key)})")
        return data

    def drop(self, key: str) -> None:
        try:
            os.remove(self.path(key))
        except OSError:
            pass

    # ------------------------------------------------------------ ingest
    def ingest_pack(self, base: str) -> int:
        """Index every locally-stored chunk of an existing v2 pack into
        the store (warming the CAS from snapshots the host already has).
        Returns the number of objects added."""
        from repro_torch.serialization.pack import PackReaderV2
        added = 0
        with PackReaderV2(base, verify=False) as r:
            for _name, _j, c in r.own_chunks():
                key = chunk_key(c)
                if not self.has(key):
                    added += self.put(key, r.read_stored_chunk(c))
        return added

    # ------------------------------------------------------------ report
    def stats(self) -> Dict[str, Any]:
        n, nbytes = 0, 0
        for dirpath, _dirs, files in os.walk(self.objects):
            for name in files:
                if name.endswith(".tmp") or ".tmp." in name:
                    continue
                n += 1
                nbytes += os.path.getsize(os.path.join(dirpath, name))
        return {"objects": n, "bytes": nbytes, "root": self.root}

    def fsck(self, repair: bool = False) -> List[str]:
        """CRC-check every object; returns the corrupt keys.

        With ``repair=True`` each corrupt object is moved aside into
        ``<root>/quarantine/`` (outside the object tree, so ``stats`` and
        ``have`` no longer see it): the next ``get`` raises ``KeyError``
        instead of ``CASCorruption`` and the replicator's materializer
        heals the chunk from source — bad bytes can never be re-served.
        """
        bad = []
        for dirpath, _dirs, files in os.walk(self.objects):
            for name in files:
                if name.endswith(".tmp") or ".tmp." in name:
                    continue
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    if crc32(f.read()) != _stored_crc_of(name):
                        bad.append(name)
                        if repair:
                            qdir = os.path.join(self.root, QUARANTINE_DIR)
                            os.makedirs(qdir, exist_ok=True)
                            os.replace(path, os.path.join(qdir, name))
        return sorted(bad)

    # ------------------------------------------------------- round state
    # Pre-copy migration rounds persist their ledger *in the destination
    # CAS* (beside the objects they shipped), so an interrupted migration
    # resumes from the target's own record: a fresh source process reads
    # round_state(tag), sees how far convergence got, and the next
    # push_round re-negotiates have/want against the already-landed
    # objects — nothing is re-sent, and the ledger survives a source kill.
    def _rounds_path(self, tag: str) -> str:
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in tag)
        return os.path.join(self.root, ROUNDS_DIR, f"{safe}.json")

    def round_state(self, tag: str) -> List[Dict[str, Any]]:
        """The persisted per-round ledger for one migration, oldest first
        (empty when no round has completed)."""
        path = self._rounds_path(tag)
        if not os.path.exists(path):
            return []
        try:
            with open(path) as f:
                return list(json.load(f))
        except Exception:
            return []

    def append_round(self, tag: str, record: Dict[str, Any]
                     ) -> List[Dict[str, Any]]:
        """Append one completed round to the ledger (atomic rewrite) and
        return the updated ledger."""
        state = self.round_state(tag)
        state.append(dict(record, t=time.time()))
        path = self._rounds_path(tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=2, default=str)
        os.replace(tmp, path)
        return state

    def clear_rounds(self, tag: str) -> None:
        """Drop a migration's round ledger (after a completed handoff)."""
        try:
            os.remove(self._rounds_path(tag))
        except OSError:
            pass

    # ------------------------------------------------------ transfer log
    def log_transfer(self, record: Dict[str, Any]) -> None:
        """Append one push's stats to the store's transfer log (what
        the reference's ``repro transfer-stats`` reads)."""
        self.log_transfers([record])

    def log_transfers(self, records: List[Dict[str, Any]]) -> None:
        """Append several pushes' stats in one rewrite of the log: the
        ranks' pushes of one image, written by rank 0 alone (two writers
        of the one file would lose each other's records)."""
        path = os.path.join(self.root, TRANSFER_LOG)
        log = self.transfer_log()
        now = time.time()
        log.extend(dict(r, t=now) for r in records)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(log, f, indent=2, default=str)
        os.replace(tmp, path)

    def transfer_log(self) -> List[Dict[str, Any]]:
        path = os.path.join(self.root, TRANSFER_LOG)
        if not os.path.exists(path):
            return []
        try:
            with open(path) as f:
                return list(json.load(f))
        except Exception:
            return []


def default_cas_dir(peer_dir: str) -> str:
    return os.path.join(peer_dir, ".cas")

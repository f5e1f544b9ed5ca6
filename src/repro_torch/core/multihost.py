"""Multi-host unified snapshots: barrier + two-phase manifest commit.

Port of the reference's ``core/multihost.py``: the filesystem barrier is
host code, so nothing here touches a device.

The paper's multiprocess container trees (§4.2) need every process frozen
before the image is cut; our 1000-node analogue is every *host* dumping its
addressable shards, with the image valid only once ALL hosts have written.
Protocol (coordinator = host 0, the CRIU "main" process):

  phase 1  every host writes  host{i:04}.pack  +  PREPARED.{i}  (atomic)
  barrier  coordinator waits for all PREPARED markers (with deadline)
  phase 2  coordinator writes MANIFEST.json (atomic rename = commit point)

A crash before phase 2 leaves no manifest → the image does not exist and
restore falls back to the previous committed snapshot (the same torn-image
guarantee as the single-host path, extended across hosts).  The barrier is
filesystem-based (shared checkpoint directory — the common case for
GCS/NFS-backed training clusters).

On restore every host reads only the entries whose shards it will hold
(the manifest's locations table is global), so restore bandwidth scales
with host count — the paper's per-GPU restore parallelism, at host
granularity.

The port runs it across the ranks of a process group, one per card
(``core/snapshot_io.py``'s writer, given a barrier by the engine): a
rank is a host.  Each marker carries the rank's part of the manifest
(:meth:`MultiHostCommit.prepared_meta` reads them back for the merge),
and an ``attempt`` token, agreed by every rank when the dump starts,
keeps a marker or a manifest left by an earlier attempt at the same step
(a torn commit, a re-dump) from counting for this one.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from repro_torch.core.snapshot_io import MANIFEST, snapshot_dir
from repro_torch.serialization.integrity import (atomic_write_bytes,
                                                  read_json)


class BarrierTimeout(RuntimeError):
    pass


def _prepared_path(dir_: str, host_id: int) -> str:
    return os.path.join(dir_, f"PREPARED.{host_id:04d}")


class MultiHostCommit:
    """Two-phase commit for one snapshot step across `num_hosts` hosts."""

    def __init__(self, run_dir: str, step: int, host_id: int,
                 num_hosts: int, deadline_s: float = 300.0,
                 attempt: Optional[str] = None, poll_s: float = 0.05):
        self.run_dir = run_dir
        self.step = step
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.deadline_s = deadline_s
        self.attempt = attempt
        self.poll_s = poll_s
        self.dir = snapshot_dir(run_dir, step)

    # ------------------------------------------------------------ phase 1
    def prepare(self, meta: Optional[Dict[str, Any]] = None) -> None:
        """Mark this host's pack as durably written (called after the
        host's SnapshotWriter has fsync'd its pack)."""
        import json
        record = {"host": self.host_id, "time": time.time(),
                  "meta": meta or {}}
        if self.attempt is not None:
            record["attempt"] = self.attempt
        atomic_write_bytes(_prepared_path(self.dir, self.host_id),
                           json.dumps(record).encode())

    def _markers(self) -> Dict[int, Dict[str, Any]]:
        """host -> its marker's record, this attempt's only (a marker
        still being written, ``PREPARED.i.tmp``, is not one)."""
        import json
        if not os.path.isdir(self.dir):
            return {}
        out = {}
        for n in os.listdir(self.dir):
            parts = n.split(".")
            if len(parts) != 2 or parts[0] != "PREPARED":
                continue
            try:
                with open(os.path.join(self.dir, n)) as f:
                    record = json.load(f)
            except (OSError, ValueError):
                continue
            if self.attempt is None or \
                    record.get("attempt") == self.attempt:
                out[int(parts[1])] = record
        return out

    def prepared_hosts(self) -> List[int]:
        return sorted(self._markers())

    def prepared_meta(self) -> Dict[int, Dict[str, Any]]:
        """host -> the `meta` its marker carries."""
        return {h: r.get("meta", {}) for h, r in self._markers().items()}

    # ------------------------------------------------------------ barrier
    def wait_all_prepared(self, poll_s: Optional[float] = None
                          ) -> List[int]:
        poll_s = self.poll_s if poll_s is None else poll_s
        t0 = time.monotonic()
        while True:
            hosts = self.prepared_hosts()
            if len(hosts) >= self.num_hosts:
                return hosts
            if time.monotonic() - t0 > self.deadline_s:
                raise BarrierTimeout(
                    f"step {self.step}: only {len(hosts)}/{self.num_hosts} "
                    f"hosts prepared within {self.deadline_s}s "
                    f"(missing: {sorted(set(range(self.num_hosts)) - set(hosts))})")
            time.sleep(poll_s)

    # ------------------------------------------------------------ phase 2
    @property
    def is_coordinator(self) -> bool:
        return self.host_id == 0

    def commit(self, manifest_writer) -> str:
        """Coordinator only: barrier on all hosts, then cut the manifest.
        `manifest_writer` is a zero-arg callable that atomically writes
        MANIFEST.json and returns the snapshot path."""
        assert self.is_coordinator, "only host 0 commits"
        self.wait_all_prepared()
        path = manifest_writer()
        # clean the markers (manifest presence is the commit record)
        for h in self.prepared_hosts():
            try:
                os.remove(_prepared_path(self.dir, h))
            except OSError:
                pass
        return path

    def committed(self) -> bool:
        path = os.path.join(self.dir, MANIFEST)
        if self.attempt is None or not os.path.exists(path):
            return os.path.exists(path)
        try:
            return read_json(path).get("attempt") == self.attempt
        except (OSError, ValueError):
            return False

    def wait_committed(self, poll_s: Optional[float] = None) -> None:
        """Non-coordinator hosts: block until the coordinator commits (or
        the deadline passes — after which the snapshot must be treated as
        aborted and the host resumes)."""
        poll_s = self.poll_s if poll_s is None else poll_s
        t0 = time.monotonic()
        while not self.committed():
            if time.monotonic() - t0 > self.deadline_s:
                raise BarrierTimeout(
                    f"step {self.step}: coordinator did not commit within "
                    f"{self.deadline_s}s")
            time.sleep(poll_s)


def merge_host_manifests(run_dir: str, step: int, num_hosts: int,
                         topology: Dict[str, Any],
                         per_host_meta: Dict[int, Dict[str, Any]]
                         ) -> Dict[str, Any]:
    """Build the global manifest from per-host metadata (coordinator side).
    Each host's `meta` maps its entry names to pack locations; the merged
    manifest's locations table is their disjoint union."""
    locations: Dict[str, str] = {}
    entry_crcs: Dict[str, int] = {}
    states = set()
    files = []
    for h in range(num_hosts):
        m = per_host_meta.get(h, {})
        locations.update(m.get("locations", {}))
        entry_crcs.update(m.get("entry_crcs", {}))
        states.update(m.get("states", []))
        files.extend(m.get("files", []))
    return {
        "format": 1,
        "step": step,
        "timestamp": time.time(),
        "topology": topology,
        "has_device_state": True,
        "num_hosts": num_hosts,
        "states": sorted(states),
        "locations": locations,
        "entry_crcs": entry_crcs,
        "files": sorted(files),
        "parent": None,
        "stats": {},
        "reused_bytes": 0,
        "written_bytes": 0,
    }

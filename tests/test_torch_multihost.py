"""Multi-host two-phase commit in the port.

Ports tests/test_multihost.py:38-145 (the two-phase commit across
threads standing in for hosts, the barrier and commit timeouts, and the
torn-image guarantee through the engine) to ``repro_torch``, and holds
``merge_host_manifests`` against the reference's.  The barrier is a
filesystem protocol: nothing here touches a device, and one card is one
host, so these CPU tests are what holds this module (the chip smoke does
not run it).
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.multihost import merge_host_manifests as jax_merge
from repro_torch.core import SnapshotEngine
from repro_torch.core.multihost import (BarrierTimeout, MultiHostCommit,
                                        merge_host_manifests)
from repro_torch.core.snapshot_io import (MANIFEST, SnapshotStore,
                                          SnapshotWriter, snapshot_dir)
from repro_torch.serialization.integrity import atomic_write_json


def _write_host_pack(run_dir, step, host_id, arr):
    w = SnapshotWriter(run_dir, step, host_id=host_id)
    w.write_states({"train_state": {
        f"w{host_id}": {"kind": "device_array",
                        "shape": list(arr.shape), "dtype": "<f4",
                        "sharding": {"type": "single", "device": "cpu"},
                        "shards": [{"index": [[0, s] for s in arr.shape],
                                    "data": arr}]}}})
    w.write_host_state({})
    w._writer.add_bytes("__commit_meta__", b"{}")
    w._writer.close()
    return {"locations": w.locations, "entry_crcs": w.entry_crcs,
            "states": sorted(w.meta), "files": [w.pack_name]}


def test_two_phase_commit_all_hosts(tmp_path):
    run = str(tmp_path)
    num_hosts = 4
    metas = {}
    commits = [MultiHostCommit(run, 1, h, num_hosts, deadline_s=10)
               for h in range(num_hosts)]

    def host_work(h):
        metas[h] = _write_host_pack(run, 1, h,
                                    np.full((4, 4), float(h), np.float32))
        time.sleep(0.02 * h)              # stagger phase-1 completion
        commits[h].prepare()

    threads = [threading.Thread(target=host_work, args=(h,))
               for h in range(1, num_hosts)]
    for t in threads:
        t.start()
    host_work(0)

    def writer():
        man = merge_host_manifests(run, 1, num_hosts, {"n_devices": 4},
                                   metas)
        path = snapshot_dir(run, 1)
        atomic_write_json(os.path.join(path, MANIFEST), man)
        return path

    path = commits[0].commit(writer)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert os.path.exists(os.path.join(path, MANIFEST))
    assert commits[0].prepared_hosts() == []      # markers cleaned
    commits[2].wait_committed()                   # non-coordinators see it
    man = json.load(open(os.path.join(path, MANIFEST)))
    assert man["num_hosts"] == 4
    assert len(man["files"]) == 4
    assert any("w2" in k for k in man["locations"])


def test_barrier_timeout_lists_missing_hosts(tmp_path):
    c = MultiHostCommit(str(tmp_path), 2, 0, num_hosts=3, deadline_s=0.2)
    os.makedirs(c.dir, exist_ok=True)
    c.prepare()                            # only host 0 prepares
    with pytest.raises(BarrierTimeout) as e:
        c.wait_all_prepared()
    assert "1, 2" in str(e.value)


def test_no_manifest_before_commit_means_no_snapshot(tmp_path):
    run = str(tmp_path)
    _write_host_pack(run, 5, 0, np.zeros((2, 2), np.float32))
    MultiHostCommit(run, 5, 0, 2).prepare()
    assert SnapshotStore(run).list_steps() == []


def test_wait_committed_times_out(tmp_path):
    c = MultiHostCommit(str(tmp_path), 3, 1, 2, deadline_s=0.2)
    os.makedirs(c.dir, exist_ok=True)
    with pytest.raises(BarrierTimeout):
        c.wait_committed()


def test_coordinator_commit_times_out_without_all_hosts(tmp_path):
    """commit() raises BarrierTimeout when a host never prepares, and no
    manifest is written: the step does not exist."""
    run = str(tmp_path)
    _write_host_pack(run, 7, 0, np.zeros((2, 2), np.float32))
    c = MultiHostCommit(run, 7, 0, num_hosts=2, deadline_s=0.2)
    c.prepare()
    called = []
    with pytest.raises(BarrierTimeout):
        c.commit(lambda: called.append(1))
    assert not called
    assert not c.committed()
    assert SnapshotStore(run).list_steps() == []


def test_phase2_crash_restores_previous_committed_snapshot(tmp_path):
    """The coordinator dies after the barrier, before MANIFEST: the newer
    step is invisible and the engine restores the previous image."""
    run = str(tmp_path)
    good = {"w": torch.full((8, 8), 3.0)}
    eng = SnapshotEngine(run, device="cpu")
    eng.attach(lambda: {"train_state": good})
    eng.checkpoint(1)
    _write_host_pack(run, 2, 0, np.full((4, 4), 9.0, np.float32))
    MultiHostCommit(run, 2, 0, num_hosts=2).prepare()
    assert os.path.isdir(snapshot_dir(run, 2))
    assert SnapshotStore(run).list_steps() == [1]
    eng2 = SnapshotEngine(run, device="cpu")
    eng2.attach(lambda: {"train_state": None})
    assert torch.equal(eng2.restore()["train_state"]["w"], good["w"])


def test_merge_host_manifests_matches_reference():
    metas = {h: {"locations": {f"st::w{h}::s0":
                               f"step_00000003/host{h:04d}.pack"},
                 "entry_crcs": {f"st::w{h}::s0": 100 + h},
                 "states": ["st", f"extra{h % 2}"],
                 "files": [f"host{h:04d}.pack.0", f"host{h:04d}.pack.1"]}
             for h in (0, 2, 1)}
    ours = merge_host_manifests("run", 3, 4, {"n_devices": 4}, metas)
    ref = jax_merge("run", 3, 4, {"n_devices": 4}, metas)
    assert ours.pop("timestamp") > 0 and ref.pop("timestamp") > 0
    assert ours == ref
    assert ours["num_hosts"] == 4 and len(ours["locations"]) == 3

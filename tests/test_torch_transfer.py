"""Replication and CAS delta transfer in the port, and across the packages.

Ports tests/test_transfer.py:64-330 (delta push and warm dedup, resume of
an interrupted transfer, CAS corruption healed, the v1 whole-file
fallback, the closure, ``chunk_key``, the CAS put checks and
``ingest_pack``, the engine's replication stats, the dir replicator's
skip and re-commit, the incremental re-dump), its double-fault lazy heal
(:423), tests/test_replication.py and the replicator counters of
tests/test_obs.py:214-260 to ``repro_torch`` with CPU tensors.  Across the
packages: the same chain gives the same CAS keys; each package's
``DeltaReplicator`` materializes the other's chain byte for byte, and
each restores what the other materialized; a CAS warmed by one package
ships nothing for the other.  Then the serving path at smoke size: a
delta-replicated chain restored from the replica after the primary is
lost, and a torn lazy chunk healed from the replica, token-exact.
"""
import os
import shutil
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CheckpointOptions as JaxOptions
from repro.api import CheckpointSession as JaxSession
from repro.transfer import DeltaReplicator as JaxDeltaReplicator
from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.api import TransferPolicy
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import CheckpointAborted, SnapshotEngine
from repro_torch.core.lazy import LazyRestoreError
from repro_torch.core.lock import DeviceLock, LockTimeout
from repro_torch.core.replication import DirReplicator, MemReplicator
from repro_torch.core.snapshot_io import MANIFEST, SnapshotStore, snapshot_dir
from repro_torch.obs import metrics
from repro_torch.runtime.server import DecodeServer
from repro_torch.serialization.integrity import crc32
from repro_torch.serialization.pack import open_pack, pack_files, stripe_path
from repro_torch.transfer import (CASCorruption, ChunkStore, DeltaReplicator,
                                  chunk_key, transfer_closure)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain_states(steps=4, entries=6, entry_kb=64, seed=0):
    """The reference's chain: a full image, then 2 entries change a step
    (numpy, so both packages can write the same bytes)."""
    rng = np.random.default_rng(seed)
    state = {f"t{i}": rng.integers(0, 8, size=entry_kb * 256)
             .astype(np.float32) for i in range(entries)}
    names = sorted(state)
    out = []
    for step in range(1, steps + 1):
        if step > 1:
            state = dict(state)
            for i in range(2):
                k = names[(step * 2 + i) % entries]
                state[k] = rng.integers(0, 8, size=entry_kb * 256) \
                    .astype(np.float32)
        out.append(state)
    return out


def _chain(run_dir, steps=4, pack_format=2, pkg="torch", **kw):
    """Write the chain with one package; returns the last state (numpy)."""
    states = _chain_states(steps=steps, **kw)
    holder = {}
    if pkg == "jax":
        s = JaxSession(run_dir, JaxOptions(mode="sync", incremental=True,
                                           pack_format=pack_format))
        s.attach(lambda: {"train_state": {
            k: jnp.asarray(v) for k, v in holder["state"].items()}})
    else:
        s = CheckpointSession(run_dir, CheckpointOptions(
            mode="sync", incremental=True, pack_format=pack_format),
            device="cpu")
        s.attach(lambda: {"train_state": {
            k: torch.from_numpy(v) for k, v in holder["state"].items()}})
    for step, state in enumerate(states, start=1):
        holder["state"] = state
        s.checkpoint(step)
    return states[-1]


def _restore_state(run_dir, pkg="torch"):
    if pkg == "jax":
        s = JaxSession(run_dir, JaxOptions())
        s.attach(lambda: {"train_state": None})
        return {k: np.asarray(v)
                for k, v in s.restore()["train_state"].items()}
    s = CheckpointSession(run_dir, device="cpu")
    s.attach(lambda: {"train_state": None})
    return {k: v.numpy() for k, v in s.restore()["train_state"].items()}


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))


def _cas_objects(cas):
    objs = []
    for dirpath, _d, files in os.walk(cas.objects):
        objs += [os.path.join(dirpath, f) for f in files]
    return sorted(objs)


# ------------------------------------------------- tests/test_transfer.py
def test_delta_push_roundtrip_and_warm_dedup(tmp_path):
    state = _chain(str(tmp_path / "src"))
    rep = DeltaReplicator(str(tmp_path / "peer"))
    st = rep.push(str(tmp_path / "src"), 4)
    assert st["bytes_sent"] > 0 and st["steps_transferred"] >= 2
    _assert_state_equal(_restore_state(str(tmp_path / "peer")), state)
    # an identical re-push is pure negotiation: nothing moves
    st2 = DeltaReplicator(str(tmp_path / "peer")).push(
        str(tmp_path / "src"), 4)
    assert st2["bytes_sent"] == 0 and st2["steps_transferred"] == 0
    assert st2["steps_skipped"] == st["steps_transferred"]


def test_warm_cas_ships_only_the_new_delta(tmp_path):
    state = _chain(str(tmp_path / "src"), steps=5)
    rep = DeltaReplicator(str(tmp_path / "peer"))
    closure = transfer_closure(SnapshotStore(str(tmp_path / "src")), 5)
    rep.push(str(tmp_path / "src"), closure[-2])     # pre-stage the chain
    st = rep.push(str(tmp_path / "src"), 5)          # only step 5 moves
    full = sum(os.path.getsize(os.path.join(r, f))
               for s in closure
               for r in [snapshot_dir(str(tmp_path / "src"), s)]
               for f in os.listdir(r))
    assert st["bytes_sent"] < full / 2
    _assert_state_equal(_restore_state(str(tmp_path / "peer")), state)


def test_interrupted_transfer_resumes_without_resending(tmp_path,
                                                        monkeypatch):
    """Kill the ship mid-flight; the retry re-negotiates and skips every
    chunk that already landed in the target CAS."""
    state = _chain(str(tmp_path / "src"))
    peer = str(tmp_path / "peer")
    real_put = ChunkStore.put
    calls = {"n": 0}

    def flaky_put(self, key, data):
        calls["n"] += 1
        if calls["n"] > 3:
            raise IOError("link dropped")
        return real_put(self, key, data)

    rep = DeltaReplicator(peer, workers=1)           # deterministic order
    monkeypatch.setattr(ChunkStore, "put", flaky_put)
    with pytest.raises(IOError, match="link dropped"):
        rep.push(str(tmp_path / "src"), 4)
    monkeypatch.setattr(ChunkStore, "put", real_put)
    landed = ChunkStore(os.path.join(peer, ".cas")).stats()["objects"]
    assert landed == 3                               # partial transfer
    # no image committed at the target: manifests land after the payload
    assert SnapshotStore(peer).list_steps() == []
    st = DeltaReplicator(peer, workers=1).push(str(tmp_path / "src"), 4)
    assert st["chunks_reused"] >= landed             # received: not re-sent
    _assert_state_equal(_restore_state(peer), state)


def test_target_cas_corruption_detected_and_healed(tmp_path):
    """A bit-rotted CAS object is caught by its CRC while a pack is
    materialized, before any restore reads it, and healed from the
    source; the reuse is a CAS shared by two stores of one host."""
    state = _chain(str(tmp_path / "src"))
    cas_dir = str(tmp_path / "host_cas")
    DeltaReplicator(str(tmp_path / "peer_a"), cas_dir=cas_dir).push(
        str(tmp_path / "src"), 4)
    cas = ChunkStore(cas_dir)
    victim = _cas_objects(cas)[0]
    raw = open(victim, "rb").read()
    open(victim, "wb").write(b"\x00" * len(raw))
    key = os.path.basename(victim)
    with pytest.raises(CASCorruption):
        cas.get(key)
    assert cas.fsck() == [key]
    st = DeltaReplicator(str(tmp_path / "peer_b"), cas_dir=cas_dir).push(
        str(tmp_path / "src"), 4)
    assert st["corrupt_objects_healed"] >= 1
    assert cas.fsck() == []
    _assert_state_equal(_restore_state(str(tmp_path / "peer_b")), state)


def test_v1_images_fall_back_to_full_copy(tmp_path):
    state = _chain(str(tmp_path / "src"), pack_format=1)
    st = DeltaReplicator(str(tmp_path / "peer")).push(
        str(tmp_path / "src"), 4)
    assert st["files_copied"] > 0 and st["bytes_copied"] > 0
    assert st["chunks_sent"] == 0                    # no chunk index in v1
    _assert_state_equal(_restore_state(str(tmp_path / "peer")), state)


def test_transfer_closure_spans_referenced_parents(tmp_path):
    _chain(str(tmp_path / "src"), steps=4)
    closure = transfer_closure(SnapshotStore(str(tmp_path / "src")), 4)
    assert closure[-1] == 4 and 1 in closure         # full image included
    assert closure == sorted(closure)


def test_chunk_key_qualifies_size_and_stored_crc():
    a = {"raw_crc32": 1, "raw_nbytes": 10, "crc32": 2}
    assert chunk_key(a) != chunk_key(dict(a, raw_nbytes=11))
    assert chunk_key(a) != chunk_key(dict(a, crc32=3))
    assert chunk_key(a) == chunk_key(dict(a))


def test_cas_put_rejects_corrupt_payload(tmp_path):
    cas = ChunkStore(str(tmp_path / "cas"))
    key = chunk_key({"raw_crc32": 1, "raw_nbytes": 4, "crc32": 0})
    with pytest.raises(CASCorruption):
        cas.put(key, b"data")                        # crc32(b"data") != 0


def test_cas_put_same_key_concurrently(tmp_path):
    """Racing puts of one key (duplicate-content chunks from parallel
    stripe lanes) all succeed: identical bytes, atomic replace."""
    cas = ChunkStore(str(tmp_path / "cas"))
    data = b"\x00" * 4096
    key = chunk_key({"raw_crc32": crc32(data), "raw_nbytes": len(data),
                     "crc32": crc32(data)})
    barrier = threading.Barrier(4)
    errors = []

    def racer():
        try:
            barrier.wait(timeout=30)
            cas.put(key, data)
        except BaseException as e:                   # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=racer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert errors == []
    assert cas.get(key) == data
    assert cas.stats()["objects"] == 1


def test_cas_ingest_pack_warms_store_from_local_snapshots(tmp_path):
    src = str(tmp_path / "src")
    state = _chain(src)
    cas_dir = str(tmp_path / "cas")
    cas = ChunkStore(cas_dir)
    n = 0
    for step in SnapshotStore(src).list_steps():
        base = pack_files(os.path.join(snapshot_dir(src, step),
                                       "host0000.pack"))[0].rsplit(".", 1)[0]
        n += cas.ingest_pack(base)
    assert n > 0 and cas.fsck() == []
    st = DeltaReplicator(str(tmp_path / "peer"), cas_dir=cas_dir).push(src, 4)
    assert st["bytes_sent"] == 0 and st["chunks_reused"] > 0
    _assert_state_equal(_restore_state(str(tmp_path / "peer")), state)


@pytest.mark.parametrize("mode,cls", [("delta", DeltaReplicator),
                                      ("copy", DirReplicator)])
def test_options_transfer_policy_builds_replicator(tmp_path, mode, cls):
    opts = CheckpointOptions(replicate_to=str(tmp_path / "peer"),
                             transfer_policy=TransferPolicy(mode=mode))
    eng = SnapshotEngine(str(tmp_path / "run"), options=opts, device="cpu")
    assert isinstance(eng.replicator, cls)
    assert SnapshotEngine(str(tmp_path / "r2"),
                          device="cpu").replicator is None


def test_engine_replication_stats_and_delta_path(tmp_path):
    holder = {"w": torch.arange(4096, dtype=torch.float32)}
    opts = CheckpointOptions(replicate_to=str(tmp_path / "peer"),
                             transfer_policy=TransferPolicy(mode="delta"),
                             incremental=True)
    s = CheckpointSession(str(tmp_path / "run"), opts, device="cpu")
    s.attach(lambda: {"train_state": dict(holder)})
    s.checkpoint(1)
    assert s.last_stats["replica_bytes_sent"] > 0
    assert "replicate_s" in s.last_stats
    holder["w"] = holder["w"] + 1
    s.checkpoint(2)
    _assert_state_equal(_restore_state(str(tmp_path / "peer")),
                        {"w": holder["w"].numpy()})


def test_dir_replicator_skips_unchanged_files(tmp_path):
    w = torch.arange(8192, dtype=torch.float32)
    opts = CheckpointOptions(replicate_to=str(tmp_path / "peer"))
    s = CheckpointSession(str(tmp_path / "run"), opts, device="cpu")
    s.attach(lambda: {"train_state": {"w": w}})
    s.checkpoint(1)
    assert isinstance(s.engine.replicator, DirReplicator)
    assert s.last_stats["replica_files_copied"] > 0
    assert s.last_stats["replica_files_skipped"] == 0
    st = s.engine.replicator.push(str(tmp_path / "run"), 1)
    assert st["files_copied"] == 0
    assert st["files_skipped"] > 0 and st["bytes_copied"] == 0
    _assert_state_equal(_restore_state(str(tmp_path / "peer")),
                        {"w": w.numpy()})


def test_dir_replicator_repush_of_changed_step_recommits(tmp_path):
    """A re-pushed step whose content changed re-commits the peer image:
    its manifest is dropped before the payload is replaced and lands
    last."""
    holder = {"w": torch.arange(4096, dtype=torch.float32)}
    run = str(tmp_path / "run")
    s = CheckpointSession(run, CheckpointOptions(mode="sync"), device="cpu")
    s.attach(lambda: {"train_state": dict(holder)})
    s.checkpoint(1)
    rep = DirReplicator(str(tmp_path / "peer"))
    rep.push(run, 1)
    holder["w"] = holder["w"] * 2
    s.checkpoint(1)                                  # re-dump, new content
    assert rep.push(run, 1)["files_copied"] > 0
    _assert_state_equal(_restore_state(str(tmp_path / "peer")),
                        {"w": holder["w"].numpy()})


def test_incremental_redump_of_same_step_stays_restorable(tmp_path):
    run = str(tmp_path / "run")
    holder = {"w": torch.arange(4096, dtype=torch.float32)}
    s = CheckpointSession(run, CheckpointOptions(mode="sync",
                                                 incremental=True),
                          device="cpu")
    s.attach(lambda: {"train_state": dict(holder)})
    s.checkpoint(1)
    holder["w"] = holder["w"] + 1
    s.checkpoint(2)
    s.checkpoint(2)                                  # re-dump same step
    assert s.store.manifest(2)["parent"] == 1        # not itself
    reader = s.store.reader(2)
    try:
        reader.verify_all()
    finally:
        reader.close()
    _assert_state_equal(_restore_state(run), {"w": holder["w"].numpy()})


def _tear_entry_chunk(root, step, entry):
    """Flip bytes inside `entry`'s first stored chunk of `root`'s image."""
    loc = SnapshotStore(root).manifest(step)["locations"][entry]
    base = os.path.join(root, "snapshots", loc)
    with open_pack(base, verify=False) as r:
        c = r.index[entry]["chunks"][0]
    if c.get("ref"):
        base = os.path.join(root, "snapshots", c["ref"])
    with open(stripe_path(base, c["stripe"]), "r+b") as f:
        f.seek(c["offset"] + 8)
        f.write(b"\xde\xad\xbe\xef")


def test_double_fault_quarantines_with_diagnosable_error(tmp_path):
    """Local chunk torn AND the replica's copy torn: the heal pulls
    equally bad bytes, the retried entry fails again, the stream names
    the entry, and the retried restore falls back to the previous image
    (tests/test_transfer.py:423)."""
    run, peer = str(tmp_path / "run"), str(tmp_path / "peer")
    g = torch.Generator().manual_seed(0)
    state1 = {"hot": torch.randn(512, generator=g),
              "cold": {f"c{i}": torch.randn(8 * 256, generator=g)
                       for i in range(3)}}
    holder = {"state": state1}
    s = CheckpointSession(run, CheckpointOptions(mode="sync",
                                                 replicate_to=peer),
                          device="cpu")
    s.attach(lambda: {"train_state": holder["state"]})
    s.checkpoint(1)
    state2 = {"hot": state1["hot"] + 1.0,
              "cold": {k: v + 1.0 for k, v in state1["cold"].items()}}
    holder["state"] = state2
    s.checkpoint(2)
    entry = "train_state::cold/c0::s0"
    _tear_entry_chunk(run, 2, entry)         # fault 1: local image
    _tear_entry_chunk(peer, 2, entry)        # fault 2: replica, same entry
    r = CheckpointSession(
        run, CheckpointOptions(replicate_to=peer, restore_mode="lazy",
                               critical_states=("train_state/hot",)),
        device="cpu")
    r.attach(lambda: {"train_state": None})
    restored = r.restore()                   # criticals verify clean
    assert torch.equal(restored["train_state"]["hot"], state2["hot"])
    with pytest.raises(LazyRestoreError, match="cold/c0"):
        r.restore_barrier()
    again = r.restore(wait="all")            # step 2 quarantined
    assert torch.equal(again["train_state"]["hot"], state1["hot"])
    for k, v in state1["cold"].items():
        assert torch.equal(again["train_state"]["cold"][k], v)


# ---------------------------------------------- tests/test_replication.py
def _w():
    return {"w": torch.randn(16, 16, generator=torch.Generator()
                             .manual_seed(3))}


@pytest.mark.parametrize("kind", ["dir", "mem"])
def test_replicator_fallback_after_primary_loss(tmp_path, kind):
    """Dir (tests/test_replication.py:15) and in-memory (:33) peers: the
    primary's snapshots are wiped and a fresh engine restores from the
    replica."""
    primary = str(tmp_path / "primary")
    rep = DirReplicator(str(tmp_path / "peer")) if kind == "dir" \
        else MemReplicator()
    state = _w()
    eng = SnapshotEngine(primary, replicator=rep, device="cpu")
    eng.attach(lambda: {"train_state": state})
    eng.checkpoint(5)
    if kind == "mem":
        assert 5 in rep.images and MANIFEST in rep.images[5]
    shutil.rmtree(os.path.join(primary, "snapshots"))
    eng2 = SnapshotEngine(primary, replicator=rep, device="cpu")
    eng2.attach(lambda: {"train_state": None})
    restored = eng2.restore()
    assert torch.equal(restored["train_state"]["w"], state["w"])
    assert eng2.last_stats["restored_from_replica"] is True


def test_replicator_only_pushes_committed_images(tmp_path):
    """The push follows the manifest commit: a failed dump replicates
    nothing."""
    class SlowLock(DeviceLock):
        def lock(self, *a, **kw):
            raise LockTimeout("injected")

    rep = MemReplicator()
    eng = SnapshotEngine(str(tmp_path / "p"), replicator=rep, device="cpu")
    eng.device_plugin.lock = SlowLock()
    eng.attach(lambda: {"train_state": _w()})
    with pytest.raises(CheckpointAborted):
        eng.checkpoint(1)
    assert rep.images == {}


# ------------------------------------------ tests/test_obs.py:214 (port)
def test_replicator_stats_routed_and_warn_once(tmp_path):
    class NoStatsReplicator:
        def push(self, run_dir, step):
            return None

    eng = SnapshotEngine(str(tmp_path / "run"),
                         replicator=NoStatsReplicator(), device="cpu")
    eng.attach(lambda: {"train_state": _w()})
    reg = metrics.MetricsRegistry()
    metrics.install(reg)
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng.checkpoint(1)
            eng.checkpoint(2)
        hits = [x for x in w if "no last_stats" in str(x.message)]
        assert len(hits) == 1                # once, not per dump
        snap = reg.snapshot()
        assert snap["counters"]["replica.missing_stats"] == 2
        assert snap["counters"]["replica.push_count"] == 2
        assert snap["counters"]["dump.count"] == 2
    finally:
        metrics.uninstall()


def test_replicator_with_stats_mirrors_counters(tmp_path):
    eng = SnapshotEngine(str(tmp_path / "run"),
                         replicator=DirReplicator(str(tmp_path / "peer")),
                         device="cpu")
    eng.attach(lambda: {"train_state": _w()})
    reg = metrics.MetricsRegistry()
    metrics.install(reg)
    try:
        eng.checkpoint(1)
        c = reg.snapshot()["counters"]
        assert c["replica.push_count"] == 1
        assert c["replica.files_copied"] == eng.last_stats[
            "replica_files_copied"] > 0
    finally:
        metrics.uninstall()


# ----------------------------------------------------- across the packages
def _own_keys(run, pkg_store=SnapshotStore):
    """step -> {entry: [chunk keys]} of every state entry's own chunks."""
    out = {}
    for step in pkg_store(run).list_steps():
        base = os.path.join(snapshot_dir(run, step), "host0000.pack")
        with open_pack(base, verify=False) as r:
            keys = {}
            for name, _j, c in r.own_chunks():
                if not name.startswith("__"):
                    keys.setdefault(name, []).append(chunk_key(c))
        out[step] = keys
    return out


def test_same_chain_gives_same_chunk_keys_in_both_packages(tmp_path):
    for pkg in ("jax", "torch"):
        _chain(str(tmp_path / pkg), pkg=pkg)
    jk, tk = _own_keys(str(tmp_path / "jax")), _own_keys(str(tmp_path /
                                                             "torch"))
    assert jk == tk and sum(len(v) for v in tk.values()) > 6


def _stripe_bytes(run):
    """{relative path: bytes} of every pack file of every image."""
    out = {}
    for step in SnapshotStore(run).list_steps():
        d = snapshot_dir(run, step)
        for f in sorted(os.listdir(d)):
            if f != MANIFEST:
                out[f"{step}/{f}"] = open(os.path.join(d, f), "rb").read()
    return out


@pytest.mark.parametrize("writer,replicator", [("jax", "torch"),
                                               ("torch", "jax")])
def test_delta_materializes_other_packages_chain_byte_identical(
        tmp_path, writer, replicator):
    src, peer = str(tmp_path / "src"), str(tmp_path / "peer")
    state = _chain(src, pkg=writer)
    rep = (DeltaReplicator if replicator == "torch"
           else JaxDeltaReplicator)(peer)
    st = rep.push(src, 4)
    assert st["chunks_sent"] > 0 and st["steps_transferred"] == 4
    assert _stripe_bytes(peer) == _stripe_bytes(src)
    for pkg in ("jax", "torch"):                 # each restores the copy
        _assert_state_equal(_restore_state(peer, pkg), state)


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_cas_warmed_by_one_package_ships_nothing_for_the_other(
        tmp_path, first, second):
    src, cas = str(tmp_path / "src"), str(tmp_path / "cas")
    state = _chain(src)
    cls = {"torch": DeltaReplicator, "jax": JaxDeltaReplicator}
    warm = cls[first](str(tmp_path / "peer_a"), cas_dir=cas).push(src, 4)
    assert warm["chunks_sent"] > 0
    st = cls[second](str(tmp_path / "peer_b"), cas_dir=cas).push(src, 4)
    assert st["chunks_sent"] == 0 and st["bytes_sent"] == 0
    assert st["chunks_reused"] == warm["chunks_sent"] + warm["chunks_reused"]
    _assert_state_equal(_restore_state(str(tmp_path / "peer_b")), state)


# --------------------------------------------- serving path, smoke size
ARCH = "qwen1.5-0.5b"


def _server(run, **opts):
    return DecodeServer(get_smoke_config(ARCH), run, max_seq=64,
                        device="cpu", options=CheckpointOptions(**opts))


def _served_chain(run, peer):
    """A server replicating its delta images to `peer` (two sync images
    4 tokens apart); returns it and its next 4 tokens."""
    cfg = get_smoke_config(ARCH)
    srv = _server(run, incremental=True, replicate_to=peer,
                  transfer_policy=TransferPolicy(mode="delta"))
    srv.load(srv.model.init(0))
    srv.start({"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8))})
    stats = []
    for _ in range(2):
        srv.decode(4)
        srv.checkpoint(srv.pos)
        stats.append(dict(srv.session.last_stats))
    return srv, stats, srv.decode(4).copy()


def test_server_restores_from_replica_after_primary_loss(tmp_path):
    """(a) at smoke size: image 2 ships only the chunks it stores itself
    (the params stay in image 1's pack, which the peer already holds);
    with the primary's images gone, a fresh server restores from the
    replica and continues token-exact."""
    run, peer = str(tmp_path / "run"), str(tmp_path / "peer")
    srv, stats, expected = _served_chain(run, peer)
    first, second = stats
    assert first["replica_steps_transferred"] == 1
    assert second["replica_steps_transferred"] == 1
    assert second["replica_steps_skipped"] == 1          # image 1
    man = SnapshotStore(run).manifest(srv.pos - 4)
    assert man["reused_bytes"] > 0
    with open_pack(os.path.join(snapshot_dir(run, srv.pos - 4),
                                "host0000.pack")) as r:
        own = sum(c["nbytes"] for _n, _j, c in r.own_chunks())
    assert second["replica_bytes_sent"] + second["replica_bytes_reused"] \
        == own < first["replica_bytes_sent"]
    shutil.rmtree(os.path.join(run, "snapshots"))
    fresh = _server(run, replicate_to=peer,
                    transfer_policy=TransferPolicy(mode="delta"))
    assert fresh.restore() == srv.pos - 4
    assert fresh.session.last_stats["restored_from_replica"] is True
    assert np.array_equal(fresh.decode(4), expected)


def test_server_lazy_stream_heals_torn_chunk_from_replica(tmp_path):
    """(b) at smoke size: a torn background (cache) chunk of the primary
    image raises at the barrier without a replicator, and heals from the
    replica with one; the continuation is token-exact."""
    run, peer = str(tmp_path / "run"), str(tmp_path / "peer")
    srv, _, expected = _served_chain(run, peer)
    step = srv.pos - 4
    entry = next(n for n in SnapshotStore(run).manifest(step)["locations"]
                 if "::cache/" in n)
    _tear_entry_chunk(run, step, entry)
    bare = _server(run, restore_mode="lazy")
    bare.restore()
    with pytest.raises(LazyRestoreError):
        bare.decode(1)
    fresh = _server(run, restore_mode="lazy", replicate_to=peer,
                    transfer_policy=TransferPolicy(mode="delta"))
    assert fresh.restore() == step
    assert fresh.session.lazy_pending
    assert np.array_equal(fresh.decode(4), expected)
    assert fresh.session.last_stats["healed_entries"] >= 1


def test_capabilities_report_replication_like_reference():
    """The port reports what now runs: the reference's feature keys (and
    more), its transfer modes and its written pack formats."""
    from repro.api.capabilities import capabilities as jax_capabilities
    from repro_torch.api import capabilities
    ref, caps = jax_capabilities(), capabilities()
    assert set(ref["features"]) <= set(caps["features"])
    assert caps["transfer_modes"] == ref["transfer_modes"] == ["copy",
                                                               "delta"]
    assert caps["pack_formats"]["write"] == ref["pack_formats"] == [1, 2]
    for k in ("replication", "delta_transfer", "content_addressed_store"):
        assert caps["features"][k] is ref["features"][k] is True

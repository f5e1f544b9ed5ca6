"""Incremental (delta) images in the port, and chains across the packages.

Ports tests/test_engine.py:186-236 (unchanged entries are reused from the
parent; GC keeps the parents a kept image reads from) and
tests/test_data_plane.py:70-143 (pack-v2 chunk dedup through the engine;
a deleted parent pack breaks its children with a clear error and restore
falls back) to ``repro_torch`` with CPU tensors.  Then across the
packages: a chain whose parent one package wrote and whose child the
other wrote restores bitwise in both, and both packages' manifests and
chunk ``ref`` records carry the same field names.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cli as repro_cli
from repro.api import CheckpointOptions as JaxOptions
from repro.api import CheckpointSession as JaxSession
from repro.core.snapshot_io import SnapshotStore as JaxStore
from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.core.snapshot_io import SnapshotStore, snapshot_dir
from repro_torch.serialization.pack import open_pack, stripe_path


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_state(seed=0, n=4):
    g = torch.Generator().manual_seed(seed)
    return {f"w{i}": torch.randn(8, 16, generator=g) for i in range(n)}


def _session(run_dir, holder, **opts):
    s = CheckpointSession(run_dir, CheckpointOptions(**opts), device="cpu")
    s.attach(lambda: {"train_state": holder["state"]})
    return s


def _restored(run_dir, step=None):
    s = CheckpointSession(run_dir, device="cpu")
    s.attach(lambda: {"train_state": None})
    return s.restore(step=step)["train_state"]


def _assert_state_equal(restored, state):
    assert set(restored) == set(state)
    for k, v in state.items():
        assert torch.equal(restored[k], v), k


def _pack_files(base):
    out, k = [], 0
    while os.path.exists(stripe_path(base, k)):
        out.append(stripe_path(base, k))
        k += 1
    return out


# ---------------------------------------------- tests/test_engine.py:186
def test_incremental_reuses_unchanged_entries(run_dir):
    state = make_state()
    holder = {"state": state}
    s = _session(run_dir, holder, incremental=True)
    s.checkpoint(1)
    holder["state"] = dict(state, w0=state["w0"] + 1.0)   # one tensor
    s.checkpoint(2)
    man2 = SnapshotStore(run_dir).manifest(2)
    assert man2["parent"] == 1
    assert man2["reused_bytes"] > 0
    assert s.last_stats["reused_bytes"] == man2["reused_bytes"]
    locs = man2["locations"]
    assert any(loc.startswith("step_00000001") for loc in locs.values())
    assert any(loc.startswith("step_00000002") for loc in locs.values())
    # restore resolves the delta chain transparently
    _assert_state_equal(_restored(run_dir), holder["state"])


def test_gc_preserves_incremental_parents(run_dir):
    state = make_state()
    holder = {"state": state}
    s = _session(run_dir, holder, incremental=True, keep=1)
    s.checkpoint(1)
    holder["state"] = dict(state, w0=state["w0"] + 1.0)
    s.checkpoint(2)          # keep=1 would drop step 1, but 2 reads it
    assert SnapshotStore(run_dir).list_steps() == [1, 2]
    # a full (non-incremental) image lets GC actually collect
    s.engine.incremental = False
    holder["state"] = dict(state, w0=state["w0"] + 2.0)
    s.checkpoint(3)
    assert SnapshotStore(run_dir).list_steps() == [3]
    _assert_state_equal(_restored(run_dir), holder["state"])


def test_parent_is_newest_step_strictly_below(run_dir):
    """A re-dump of an existing step never takes the image it overwrites
    as its own parent (src/repro/core/engine.py:411-431)."""
    holder = {"state": make_state()}
    s = _session(run_dir, holder, incremental=True)
    s.checkpoint(1)
    s.checkpoint(2)
    s.checkpoint(2)
    assert s.store.manifest(2)["parent"] == 1
    _assert_state_equal(_restored(run_dir), holder["state"])


# ----------------------------------------- tests/test_data_plane.py:70
def test_v2_chunk_dedup_through_engine(run_dir):
    big = torch.arange(1 << 20, dtype=torch.float32)   # 4 MiB -> 4 x 1 MiB
    holder = {"state": {"big": big}}
    s = _session(run_dir, holder, incremental=True, chunk_mb=1)
    s.checkpoint(1)
    big2 = big.clone()
    big2[:4] = -1.0                                    # dirties chunk 0
    holder["state"] = {"big": big2}
    s.checkpoint(2)
    man = s.store.manifest(2)
    assert man["written_bytes"] == 1 << 20             # one chunk rewritten
    assert man["reused_bytes"] == 3 << 20
    assert 1 in man["ref_steps"]
    assert s.last_stats["hash_s"] > 0
    _assert_state_equal(_restored(run_dir), {"big": big2})
    # gc must keep step 1: step 2's chunks live in its stripes
    s.store.gc(keep=1)
    assert s.store.list_steps() == [1, 2]


# ---------------------------------------- tests/test_data_plane.py:126
def test_deleted_parent_pack_breaks_children_with_clear_error(run_dir):
    state = {f"t{i}": torch.arange(4096, dtype=torch.float32) * i
             for i in range(4)}
    holder = {"state": state}
    s = _session(run_dir, holder, incremental=True, chunk_mb=1)
    s.checkpoint(1)
    holder["state"] = dict(state, t0=state["t0"] + 1.0)
    s.checkpoint(2)
    # step 3: a full image, independent of the chain
    full = dict(holder["state"], t1=holder["state"]["t1"] + 2.0)
    _session(run_dir, {"state": full}).checkpoint(3)
    # delete step 1's pack: steps 1 AND 2 (its delta child) are broken
    for p in _pack_files(os.path.join(snapshot_dir(run_dir, 1),
                                      "host0000.pack")):
        os.remove(p)
    r = CheckpointSession(run_dir, device="cpu")
    r.attach(lambda: {"train_state": None})
    with pytest.raises(Exception,
                       match="(chunk file missing|No such file|no pack)"):
        r.restore(step=2)
    _assert_state_equal(r.restore()["train_state"], full)   # falls back
    # the JAX package's verifier reports the broken steps and the intact one
    assert repro_cli.main(["verify", run_dir]) == 1


# ------------------------------------------------- across the packages
def _jax_state(step):
    x = np.arange(1 << 19, dtype=np.float32)               # 2 MiB: 2 chunks
    if step:
        x = x.copy()
        x[:4] = -1.0                                      # dirties chunk 0
    return {"x": x,
            "b": (np.arange(512, dtype=np.float32) / 7 + step),
            "n": np.arange(64, dtype=np.int32) + (step > 0)}


def _write(pkg, run, step, state):
    """Write `state` (numpy) as image `step` with the given package,
    incremental, 1 MiB chunks; b is stored as bf16."""
    if pkg == "jax":
        js = JaxSession(run, JaxOptions(incremental=True, chunk_mb=1))
        js.attach(lambda: {"st": {
            "x": jnp.asarray(state["x"]),
            "b": jnp.asarray(state["b"], dtype=jnp.bfloat16),
            "n": jnp.asarray(state["n"])}})
        js.checkpoint(step)
        return JaxStore(run).manifest(step)
    ts = CheckpointSession(run, CheckpointOptions(incremental=True,
                                                  chunk_mb=1), device="cpu")
    ts.attach(lambda: {"st": {
        "x": torch.from_numpy(state["x"]),
        "b": torch.from_numpy(state["b"]).to(torch.bfloat16),
        "n": torch.from_numpy(state["n"])}})
    ts.checkpoint(step)
    return ts.store.manifest(step)


def _child_refs(run, step):
    base = os.path.join(snapshot_dir(run, step), "host0000.pack")
    r = open_pack(base, verify=False)
    try:
        return [c for rec in r.index.values() for c in rec["chunks"]
                if c.get("ref")]
    finally:
        r.close()


@pytest.mark.parametrize("parent,child", [("jax", "torch"),
                                          ("torch", "jax")])
def test_cross_package_incremental_chain_restores_bitwise(tmp_path, parent,
                                                          child):
    run = str(tmp_path / "run")
    _write(parent, run, 0, _jax_state(0))
    want = _jax_state(1)
    man = _write(child, run, 1, want)
    assert man["parent"] == 0
    # x's chunk 1 and the whole of n... n changed; x chunk 1 is a ref
    assert man["reused_bytes"] >= 1 << 20
    assert man["written_bytes"] < want["x"].nbytes + 4096
    refs = _child_refs(run, 1)
    assert refs and all(c["ref"] == "step_00000000/host0000.pack"
                        for c in refs)
    # the port restores the chain
    out = CheckpointSession(run, device="cpu").restore()["st"]
    np.testing.assert_array_equal(out["x"].numpy(), want["x"])
    np.testing.assert_array_equal(out["n"].numpy(), want["n"])
    np.testing.assert_array_equal(
        out["b"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(jnp.asarray(want["b"], jnp.bfloat16)).view(np.uint16))
    # and so does the JAX package
    js = JaxSession(run, JaxOptions())
    js.attach(lambda: {"st": None})
    jout = js.restore()["st"]
    np.testing.assert_array_equal(np.asarray(jout["x"]), want["x"])
    np.testing.assert_array_equal(np.asarray(jout["n"]), want["n"])
    np.testing.assert_array_equal(
        np.asarray(jout["b"]).view(np.uint16),
        out["b"].view(torch.int16).numpy().view(np.uint16))
    assert repro_cli.main(["verify", run]) == 0


def test_incremental_manifest_and_ref_fields_match_reference(tmp_path):
    """The same chain written by each package: the manifests carry the
    same keys (parent, reused_bytes, written_bytes, entry_crcs,
    ref_steps, ...), the same reuse accounting and entry CRCs, and the
    chunk ref records the same fields."""
    mans, refs = {}, {}
    for pkg in ("jax", "torch"):
        run = str(tmp_path / pkg)
        _write(pkg, run, 0, _jax_state(0))
        mans[pkg] = _write(pkg, run, 1, _jax_state(1))
        refs[pkg] = _child_refs(run, 1)
    jm, tm = mans["jax"], mans["torch"]
    assert set(jm) == set(tm)
    for k in ("parent", "reused_bytes", "written_bytes", "entry_crcs",
              "ref_steps", "locations", "entry_bytes", "restore_order"):
        assert jm[k] == tm[k], k
    assert [sorted(c) for c in refs["jax"]] == \
        [sorted(c) for c in refs["torch"]]
    assert sorted(refs["torch"][0]) == sorted(
        ["stripe", "offset", "nbytes", "raw_nbytes", "crc32", "raw_crc32",
         "codec", "ref"])

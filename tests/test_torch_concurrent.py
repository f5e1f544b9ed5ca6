"""Concurrent (soft-freeze) capture in the port: validated speculation.

Ports tests/test_concurrent_capture.py to ``repro_torch`` with CPU
tensors: a dump is pinned in a brief pause, speculated while the job
keeps mutating state, then validated in a second short pause, and the
committed image is always bit-exact with the live state at the validate
pause; an op that cannot be quiesced at a capture boundary aborts the
dump with no manifest.

The port's own case: torch updates tensors in place (AdamW's params and
moments, the KV cache written by index into a view), so identity drift —
all the reference's tracker sees — misses those writes; the port's
tracker also compares each tensor's version counter.  Each such test
shows the reference's identity-only tracker missing the write and the
port's image still equal to the live tree.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core.dirty import DirtyTracker as IdentityOnlyTracker
from repro.runtime.interval import frozen_window_s
from repro_torch.api import (CheckpointOptions, CheckpointSession,
                             OptionsError, PendingWriteStalled)
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import TorchBackend, flatten_with_paths
from repro_torch.core.engine import CheckpointAborted
from repro_torch.core.streams import StreamOp, StreamSet
from repro_torch.models.lm import LM
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.runtime.trainer import TrainConfig, Trainer

WAIT_S = 60.0          # every thread wait in this file is bounded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(n=6, kb=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {f"w{i}": torch.randn(kb * 128, generator=g) for i in range(n)}


def _opts(**kw):
    base = dict(incremental=True, capture="concurrent")
    base.update(kw)
    return CheckpointOptions(**base)


def _session(run_dir, state, name="state", **kw):
    sess = CheckpointSession(run_dir, _opts(**kw), device="cpu")
    sess.attach(lambda: {name: state})
    return sess


def _restore(run_dir, step=None, name="state"):
    r = CheckpointSession(run_dir, CheckpointOptions(), device="cpu")
    r.attach(lambda: {name: None})
    return r.restore(step=step)[name]


def _begin(sess, step):
    handle = sess.checkpoint_begin(step)
    assert handle.wait_speculated(WAIT_S), "speculation hung"
    return handle


def _assert_tree_equal(restored, live):
    a, b = flatten_with_paths(restored), flatten_with_paths(live)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------- options
def test_capture_option_validated_up_front():
    with pytest.raises(OptionsError, match="capture"):
        CheckpointOptions(capture="turbo")
    with pytest.raises(OptionsError, match="pack_format=2"):
        CheckpointOptions(capture="concurrent", pack_format=1,
                          incremental=True)
    with pytest.raises(OptionsError, match="incremental"):
        CheckpointOptions(capture="concurrent", incremental=False)
    with pytest.raises(OptionsError, match="async"):
        CheckpointOptions(capture="concurrent", incremental=True,
                          mode="async")


def test_concurrent_requires_dirty_tracking_backend(run_dir, monkeypatch):
    monkeypatch.setattr(TorchBackend, "features",
                        frozenset({"device_arrays"}))
    with pytest.raises(OptionsError, match="dirty_tracking"):
        CheckpointSession(run_dir, _opts(), device="cpu")


# ------------------------------------------------------------- bit-exact
def test_concurrent_image_bit_exact_vs_sync_dump(tmp_path):
    state = _state()
    sync_dir, conc_dir = str(tmp_path / "sync"), str(tmp_path / "conc")
    s = CheckpointSession(sync_dir, CheckpointOptions(incremental=True),
                          device="cpu")
    s.attach(lambda: {"state": state})
    s.checkpoint(1)
    c = _session(conc_dir, state)
    assert c.checkpoint(1)              # begin + speculate + finalize
    ms, mc = s.store.manifest(1), c.store.manifest(1)
    assert ms["entry_crcs"] == mc["entry_crcs"]
    assert ms.get("capture") == "sync"
    assert mc.get("capture") == "concurrent"
    cs = mc["capture_stats"]
    assert cs["speculated_entries"] == len(state)
    assert cs["recaptured_entries"] == 0
    assert cs["frozen_s"] == pytest.approx(
        cs["pin_pause_s"] + cs["validate_pause_s"])
    _assert_tree_equal(_restore(conc_dir), state)


def test_frozen_window_is_locked_pause_not_speculation(tmp_path):
    """frozen_window_s must report pin + validate, not the whole dump."""
    c = _session(str(tmp_path / "c"), _state(n=8, kb=256))
    _begin(c, 1)
    c.checkpoint_finalize()
    st = c.last_stats
    assert frozen_window_s(st) == st["locked_total_s"]
    assert st["locked_total_s"] <= st["total_s"]
    assert st["speculate_s"] > 0


# -------------------------------------------------- interleaving matrix
def test_prefetch_retired_at_pin_lands_in_image(tmp_path):
    """A quiescable prefetch in flight when the dump begins is applied
    before the pin: its write is captured."""
    state = _state()
    c = _session(str(tmp_path / "c"), state)
    streams = StreamSet()
    c.engine.device_plugin.attach_streams(streams)

    def land_prefetch():
        state["w0"][:8] = 123.0

    streams.enqueue("h2d", StreamOp("prefetch", targets=("state::w0",),
                                    apply=land_prefetch))
    c.checkpoint(1)
    assert torch.all(_restore(str(tmp_path / "c"))["w0"][:8] == 123.0)


def test_mutation_during_speculation_is_recaptured(tmp_path):
    state = _state()
    c = _session(str(tmp_path / "c"), state)
    streams = StreamSet()
    c.engine.device_plugin.attach_streams(streams)
    handle = _begin(c, 1)
    assert c.concurrent_capture is handle

    def dispatch_lands():
        state["w1"][:] = -7.0

    streams.enqueue("compute", StreamOp("dispatch", targets=("state::w1",),
                                        apply=dispatch_lands))
    c.checkpoint_finalize()
    st = c.last_stats
    assert st["dirty_entries"] >= 1
    assert st["recaptured_entries"] >= 1
    restored = _restore(str(tmp_path / "c"))
    assert torch.equal(restored["w1"], torch.full_like(state["w1"], -7.0))
    _assert_tree_equal(restored, state)


def test_rebind_detected_by_identity_drift(tmp_path):
    """The step returns a *new* tensor for the same key: no note fires,
    identity drift alone must flag the entry."""
    state = _state()
    c = _session(str(tmp_path / "c"), state)
    _begin(c, 1)
    state["w2"] = torch.full_like(state["w2"], 42.0)   # rebind, no note
    c.checkpoint_finalize()
    assert c.last_stats["dirty_entries"] >= 1
    _assert_tree_equal(_restore(str(tmp_path / "c")), state)


def test_structural_drift_add_and_drop_entries(tmp_path):
    state = _state()
    c = _session(str(tmp_path / "c"), state)
    _begin(c, 1)
    state["fresh"] = torch.ones(16)                   # appears mid-capture
    state.pop("w3")                                   # vanishes mid-capture
    c.checkpoint_finalize()
    restored = _restore(str(tmp_path / "c"))
    assert "w3" not in restored
    _assert_tree_equal(restored, state)


def test_unsafe_collective_at_finalize_aborts_cleanly(tmp_path):
    state = _state()
    c = _session(str(tmp_path / "c"), state)
    streams = StreamSet()
    c.engine.device_plugin.attach_streams(streams)
    _begin(c, 1)
    streams.enqueue("collective", StreamOp("allreduce", quiescable=False))
    with pytest.raises(CheckpointAborted, match="unsafe op in flight"):
        c.checkpoint_finalize()
    assert c.engine.concurrent_capture is None
    assert c.store.latest_step() is None              # no torn manifest
    assert streams.clear_stuck() == 1
    assert c.checkpoint(2) and c.store.latest_step() == 2
    _assert_tree_equal(_restore(str(tmp_path / "c")), state)


def test_unsafe_op_at_pin_aborts_before_any_speculation(tmp_path):
    c = _session(str(tmp_path / "c"), _state())
    streams = StreamSet()
    c.engine.device_plugin.attach_streams(streams)
    streams.enqueue("collective", StreamOp("allreduce", quiescable=False))
    with pytest.raises(CheckpointAborted, match="unsafe op in flight"):
        c.checkpoint_begin(1)
    assert c.engine.concurrent_capture is None
    assert c.store.latest_step() is None
    streams.clear_stuck()
    assert c.checkpoint(1)


def test_second_dump_settles_open_capture_first(tmp_path):
    c = _session(str(tmp_path / "c"), _state())
    c.checkpoint_begin(1)
    # a second dump while a soft-freeze is open settles it first
    assert c.checkpoint(2)
    assert c.store.latest_step() == 2
    assert c.store.manifest(1).get("capture") == "concurrent"


def test_wait_pending_timeout_raises_diagnosable(tmp_path):
    state = _state(n=2, kb=4)
    c = CheckpointSession(str(tmp_path / "c"),
                          CheckpointOptions(mode="async"), device="cpu")
    c.attach(lambda: {"state": state})
    c.checkpoint(1)
    c.wait_pending(timeout_s=WAIT_S)                  # drains normally
    release = threading.Event()
    wedged = threading.Thread(target=release.wait, args=(WAIT_S,),
                              daemon=True)
    wedged.start()
    c.engine._pending = wedged
    c.engine._pending_ctx = None
    with pytest.raises(PendingWriteStalled, match="still running"):
        c.wait_pending(timeout_s=0.05)
    release.set()                                     # I/O recovers
    wedged.join(WAIT_S)
    assert not wedged.is_alive()
    c.wait_pending(timeout_s=5.0)                     # reaps cleanly
    assert c.engine._pending is None


# ------------------------------------------ in-place writes (the port's)
def test_in_place_adamw_update_is_dirty_and_recaptured(tmp_path):
    """AdamW updates params, moments and step in place: no identity
    changes.  An identity-only tracker misses every leaf; the port's
    flags them all, and the image equals the live tree."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=g),
              "b": torch.randn(32, generator=g)}
    opt = AdamW(lr=constant(1e-2))
    state = {"params": params, "opt": opt.init(params)}
    c = _session(str(tmp_path / "c"), state, name="train_state")
    handle = _begin(c, 1)
    before = c.engine.device_plugin.flatten_keys({"train_state": state})
    ident = IdentityOnlyTracker()
    ident.pin(before)
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    opt.update(grads, state["opt"], state["params"])
    live = c.engine.device_plugin.flatten_keys({"train_state": state})
    assert ident.dirty_keys(live) == set()         # identity saw nothing
    assert handle._tracker.dirty_keys(live) == set(live)
    c.checkpoint_finalize()
    st = c.last_stats
    assert st["dirty_entries"] == len(live)
    assert st["recaptured_entries"] == len(live)
    raw = _restore(str(tmp_path / "c"), name="train_state")
    _assert_tree_equal(raw["params"], state["params"])
    assert torch.equal(raw["opt"]["step"], state["opt"].step)
    _assert_tree_equal(raw["opt"]["m"], state["opt"].m)
    _assert_tree_equal(raw["opt"]["v"], state["opt"].v)


def test_write_by_index_into_cache_view_is_dirty(tmp_path):
    """A decode step writes the KV cache by index into a per-layer view
    of the stacked cache leaf; views share their base's version counter,
    so the stacked leaf is dirty.  The untouched params are not."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = LM(cfg, compute_dtype=torch.float32, device="cpu")
    params = model.init(0)
    cache = model.init_cache(2, 16)
    state = {"params": params, "cache": cache}
    c = _session(str(tmp_path / "c"), state, name="serve_state")
    handle = _begin(c, 1)
    live0 = c.engine.device_plugin.flatten_keys({"serve_state": state})
    ident = IdentityOnlyTracker()
    ident.pin(live0)
    model.decode_step(params, cache, torch.tensor([3, 5]), 0)
    live = c.engine.device_plugin.flatten_keys({"serve_state": state})
    kv = {k for k in live if k.startswith("serve_state::cache/")}
    assert kv and ident.dirty_keys(live) == set()
    assert handle._tracker.dirty_keys(live) == kv
    c.checkpoint_finalize()
    assert c.last_stats["dirty_entries"] == len(kv)
    assert c.last_stats["recaptured_entries"] == len(kv)
    raw = _restore(str(tmp_path / "c"), name="serve_state")
    _assert_tree_equal(raw["cache"], cache)
    _assert_tree_equal(raw["params"], params)


# ---------------------------------------------------------------- trainer
def _trainer(run, ckpt):
    tcfg = TrainConfig(batch_size=2, seq_len=16, total_steps=8,
                       warmup_steps=2, ckpt_every=2,
                       compute_dtype=torch.float32, remat=False, ckpt=ckpt)
    return Trainer(get_smoke_config("qwen1.5-0.5b"), tcfg, run, device="cpu")


def test_trainer_loop_with_concurrent_capture(tmp_path):
    run = str(tmp_path / "r")
    tr = _trainer(run, _opts())
    out = tr.run(6)
    assert out["steps"] == 6
    assert tr.session.concurrent_capture is None      # all settled
    steps = tr.session.store.list_steps()
    assert steps, "periodic concurrent dumps must have committed"
    m = tr.session.store.manifest(steps[-1])
    assert m.get("capture") == "concurrent"
    # a capture must not perturb the job: the losses of a run without one
    ref = _trainer(str(tmp_path / "ref"), CheckpointOptions())
    ref.run(6)
    assert ref.metrics_history["loss"] == tr.metrics_history["loss"]
    # restore-into-fresh-trainer round-trips, bitwise
    tr2 = _trainer(run, _opts())
    assert tr2.restore() == steps[-1]
    _assert_tree_equal(tr2.params, tr.params)
    _assert_tree_equal(tr2.opt_state.m, tr.opt_state.m)

"""Priority-ordered lazy restore ("resume-before-read") in the port.

Ports tests/test_lazy_restore.py (schedule recording, the critical-set
split, background materialization, the corruption matrix — a torn or
killed stream makes the barrier raise and the retry fall back — pinning
against gc, superseding restores, per-call ``wait=``, the options) to
``repro_torch`` with CPU tensors.  The trainer with a critical set that
leaves params in the stream joins deterministically (the reference test
at tests/test_lazy_restore.py:294 races its stream: ROADMAP §C).  The
server's and the trainer's lazy restores continue exactly as eager ones
do.
"""
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.api import CheckpointOptions, CheckpointSession, OptionsError
from repro_torch.configs import get_smoke_config
from repro_torch.core.lazy import (LazyMaterializer, LazyRestoreError,
                                   match_critical)
from repro_torch.core.snapshot_io import snapshot_dir
from repro_torch.runtime.server import DecodeServer
from repro_torch.runtime.trainer import TrainConfig, Trainer
from repro_torch.serialization.pack import open_pack, stripe_path

WAIT_S = 60.0          # every thread wait in this file is bounded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_shape_state(n=4, kb=8, seed=0):
    g = torch.Generator().manual_seed(seed)

    def block():
        return torch.randint(0, 9, (kb * 256,), generator=g).float()

    keys = [f"w{i}" for i in range(n)]
    return {"params": {k: block() for k in keys},
            "opt": {"m": {k: block() for k in keys},
                    "v": {k: block() for k in keys}}}


def _bump(state, d):
    return {"params": {k: v + d for k, v in state["params"].items()},
            "opt": {slot: {k: v + d for k, v in state["opt"][slot].items()}
                    for slot in ("m", "v")}}


def _session(run_dir, holder, **opts):
    s = CheckpointSession(run_dir, CheckpointOptions(**opts), device="cpu")
    s.attach(lambda: {"train_state": holder["state"]})
    return s


LAZY = dict(restore_mode="lazy", critical_states=("train_state/params",))


def _barrier(session):
    """restore_barrier(), after a bounded wait for the stream to stop."""
    mat = session.engine._lazy
    if mat is not None:
        assert mat.wait_done(WAIT_S), "lazy stream hung"
    return session.restore_barrier()


def _assert_exact(restored, state):
    for k, v in state["params"].items():
        assert torch.equal(restored["train_state"]["params"][k], v), k
    for slot in ("m", "v"):
        for k, v in state["opt"][slot].items():
            assert torch.equal(restored["train_state"]["opt"][slot][k], v)


def _corrupt_background_chunk(run_dir, step,
                              entry="train_state::opt/m/w0::s0"):
    """Flip bytes inside a cold (non-critical) entry's first chunk."""
    base = os.path.join(snapshot_dir(run_dir, step), "host0000.pack")
    r = open_pack(base, verify=False)
    c = r.index[entry]["chunks"][0]
    r.close()
    with open(stripe_path(base, c["stripe"]), "r+b") as f:
        f.seek(c["offset"] + 8)
        f.write(b"\xde\xad\xbe\xef")


# ------------------------------------------------------------- mechanics
def test_manifest_records_restore_order_and_entry_bytes(run_dir):
    s = _session(run_dir, {"state": _train_shape_state()})
    s.register_host_state("cursor", lambda: {"step": 1}, lambda st: None)
    s.checkpoint(1)
    m = s.store.manifest(1)
    order = m["restore_order"]
    assert order[-1] == "__host__"           # host blobs restore last
    assert set(m["entry_bytes"]) == set(order)
    assert all(m["entry_bytes"][n] > 0 for n in order)
    reader = s.store.reader(1, verify=False)
    try:
        assert reader.entry_schedule()[0][0] == "train_state"
        assert reader.restore_order() == order
    finally:
        reader.close()


def test_match_critical_specs():
    assert match_critical("train_state", "params/w0", ("train_state",))
    assert match_critical("train_state", "params/w0",
                          ("train_state/params",))
    assert not match_critical("train_state", "opt/m/w0",
                              ("train_state/params",))
    # prefix match is path-component-wise, not string-wise
    assert not match_critical("train_state", "params_ema/w0",
                              ("train_state/params",))
    assert not match_critical("other", "params/w0", ("train_state",))


def test_lazy_restore_bit_exact_and_barrier(run_dir):
    state = _train_shape_state()
    _session(run_dir, {"state": state}).checkpoint(1)
    r = _session(run_dir, {"state": None}, **LAZY)
    restored = r.restore()
    # resumed on the critical set: params placed, stream outstanding
    assert "params" in restored["train_state"]
    assert r.lazy_pending
    st = r.last_stats
    assert st["restore_mode"] == "lazy"
    assert st["critical_entries"] == len(state["params"])
    assert "restore_critical_s" in st
    full = _barrier(r)
    assert not r.lazy_pending
    _assert_exact(full, state)
    assert r.last_stats["background_entries"] == 2 * len(state["params"])
    assert r.last_stats["restore_background_s"] >= 0.0
    assert _barrier(r) is full       # a second barrier: no-op


def test_lazy_wait_all_equals_eager(run_dir):
    state = _train_shape_state()
    _session(run_dir, {"state": state}).checkpoint(1)
    r = _session(run_dir, {"state": None}, **LAZY)
    full = r.restore(wait="all")             # lazy machinery, joined
    assert not r.lazy_pending
    _assert_exact(full, state)
    with pytest.raises(ValueError, match="wait"):
        r.restore(wait="sometimes")


def test_restore_into_joins_lazy_stream(run_dir):
    state = _train_shape_state()
    _session(run_dir, {"state": state}).checkpoint(1)
    r = _session(run_dir, {"state": None}, **LAZY)
    template = _bump(state, 0.0)
    out = r.restore_into(template, state="train_state")
    assert not r.lazy_pending                # template needed cold leaves
    assert torch.equal(out["opt"]["v"]["w0"], state["opt"]["v"]["w0"])


# ------------------------------------------------------ corruption matrix
def test_torn_background_chunk_barrier_raises_retry_falls_back(run_dir):
    """A cold entry's chunk is torn: the critical-set resume succeeds, the
    barrier raises, and the retry quarantines the image and falls back
    to the previous committed step."""
    state1 = _train_shape_state(seed=0)
    holder = {"state": state1}
    s = _session(run_dir, holder)
    s.checkpoint(1)
    state2 = _bump(state1, 1.0)
    holder["state"] = state2
    s.checkpoint(2)
    _corrupt_background_chunk(run_dir, 2)

    r = _session(run_dir, {"state": None}, **LAZY)
    restored = r.restore()                   # criticals verify clean
    assert torch.equal(restored["train_state"]["params"]["w0"],
                       state2["params"]["w0"])
    with pytest.raises(LazyRestoreError, match="opt/m/w0"):
        _barrier(r)
    again = r.restore()                      # step 2 quarantined
    _barrier(r)
    _assert_exact(again, state1)


def test_killed_materializer_mid_stream_then_eager_retry(run_dir,
                                                         monkeypatch):
    state = _train_shape_state()
    holder = {"state": state}
    s = _session(run_dir, holder)
    s.checkpoint(1)
    holder["state"] = {"params": state["params"],
                       "opt": _bump(state, 0.0)["opt"]}
    for slot in ("m", "v"):
        for v in holder["state"]["opt"][slot].values():
            v.mul_(2.0)
    s.checkpoint(2)

    killed = threading.Event()
    gate = threading.Event()
    orig = LazyMaterializer._load_one

    def dying(self, state_name, path):
        # hold the stream until the test decides its fate (criticals do
        # not pass through here, so restore() cannot block on it)
        assert gate.wait(WAIT_S)
        if killed.is_set():
            raise IOError("materializer killed mid-stream")
        return orig(self, state_name, path)

    monkeypatch.setattr(LazyMaterializer, "_load_one", dying)
    r = _session(run_dir, {"state": None}, **LAZY)
    r.restore()
    killed.set()                             # kill the stream mid-flight
    gate.set()
    with pytest.raises(LazyRestoreError, match="killed mid-stream"):
        _barrier(r)
    monkeypatch.setattr(LazyMaterializer, "_load_one", orig)
    again = r.restore(wait="all")            # step 2 quarantined: eager
    _assert_exact(again, state)


def test_freeze_joins_pending_stream_before_dump(run_dir):
    """A dump while a lazy stream is outstanding must not capture a
    half-restored job: freeze() joins first (and a dead stream fails the
    dump)."""
    state = _train_shape_state()
    holder = {"state": state}
    _session(run_dir, holder).checkpoint(1)
    _corrupt_background_chunk(run_dir, 1)
    r = _session(run_dir, holder, **LAZY)
    r.restore()
    with pytest.raises(LazyRestoreError):
        r.checkpoint(2)


# ------------------------------------------------------------ pin vs gc
def test_gc_skips_pinned_steps(run_dir):
    s = _session(run_dir, {"state": _train_shape_state(n=2, kb=1)})
    for step in (1, 2, 3):
        s.checkpoint(step)
    store = s.store
    store.pin(1)
    assert store.gc(keep=1) == [2]           # 1 pinned, 3 kept
    assert store.list_steps() == [1, 3]
    store.unpin(1)
    assert store.gc(keep=1) == [1]
    assert store.list_steps() == [3]


def test_superseding_restore_abandons_stream(run_dir):
    state = _train_shape_state()
    _session(run_dir, {"state": state}).checkpoint(1)
    r = _session(run_dir, {"state": None}, **LAZY)
    r.restore()
    full = r.restore(wait="all")     # cancels the outstanding stream
    _assert_exact(full, state)
    assert not r.lazy_pending


def test_wait_critical_opts_into_lazy_under_eager_options(run_dir):
    state = _train_shape_state()
    _session(run_dir, {"state": state}).checkpoint(1)
    r = _session(run_dir, {"state": None},
                 critical_states=("train_state/params",))
    restored = r.restore(wait="critical")
    assert r.lazy_pending
    assert r.last_stats["restore_mode"] == "lazy"
    full = _barrier(r)
    assert full is restored
    _assert_exact(full, state)


def test_lazy_options_validate():
    o = CheckpointOptions(restore_mode="lazy",
                          critical_states=("a", "b/c/d"))
    assert o.replace() == o
    assert CheckpointOptions(critical_states=["x"]).critical_states == ("x",)
    with pytest.raises(OptionsError):
        CheckpointOptions(restore_mode="sometimes")
    with pytest.raises(OptionsError):
        CheckpointOptions(critical_states=("", "ok"))


# ------------------------------------------------- trainer and server
TCFG = dict(batch_size=2, seq_len=16, total_steps=8, warmup_steps=2, seed=0,
            compute_dtype=torch.float32, remat=False, ckpt_every=4)


def _trainer(run, **ckpt):
    tcfg = TrainConfig(**TCFG, ckpt=CheckpointOptions(**ckpt))
    return Trainer(get_smoke_config("qwen1.5-0.5b"), tcfg, run, device="cpu")


def test_trainer_partial_critical_spec_joins_deterministically(tmp_path):
    """A critical set that leaves the params in the stream joins it before
    the params are rebuilt — decided by the spec, never by which leaves
    happen to have landed."""
    run = str(tmp_path / "run")
    _trainer(run).run_until(5)                # image at step 4
    for _ in range(3):
        lazy = _trainer(run, restore_mode="lazy",
                        critical_states=("train_state/opt",))
        assert lazy.restore() == 4
        assert lazy._pending_opt_template is None     # stream joined
        assert not lazy.session.lazy_pending
        lazy.run_until(6)                     # still trains


def test_trainer_lazy_restore_continues_bitwise_as_eager(tmp_path):
    run = str(tmp_path / "run")
    _trainer(run).run_until(5)
    runs = {}
    for mode in ("eager", "lazy"):
        t = _trainer(run, restore_mode=mode)
        assert t.restore(step=4) == 4
        if mode == "lazy":
            assert t.session.options.critical_states == (
                "train_state/params",)
            assert t._pending_opt_template is not None
            assert t.session.last_stats["critical_entries"] > 0
        t.run_until(8)
        runs[mode] = t
    e, z = runs["eager"], runs["lazy"]
    assert e.metrics_history["loss"] == z.metrics_history["loss"]
    from repro_torch.core.device_plugin import flatten_with_paths
    for tree in ("params", "opt_state"):
        a = flatten_with_paths(getattr(e, tree))
        b = flatten_with_paths(getattr(z, tree))
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-2.7b"])
def test_server_lazy_cold_restore_continues_token_exact(tmp_path, arch):
    cfg = get_smoke_config(arch)
    run = str(tmp_path / "run")
    srv = DecodeServer(cfg, run, max_seq=64, device="cpu")
    srv.load(srv.model.init(0))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    srv.start({"tokens": prompt})
    srv.decode(3)
    srv.checkpoint(srv.pos)
    expected = srv.decode(4).copy()

    fresh = DecodeServer(cfg, run, max_seq=64, device="cpu",
                         options=CheckpointOptions(restore_mode="lazy"))
    assert fresh.restore() == srv.pos - 4
    st = fresh.session.last_stats
    assert st["restore_mode"] == "lazy"
    assert fresh.session.lazy_pending                 # cache streaming
    assert fresh.cache is None
    assert np.array_equal(fresh.decode(4), expected)  # joined at first use
    assert not fresh.session.lazy_pending

"""Pre-copy live migration in the port: TransferPolicy, the convergence
controller, the CAS round ledger, and the mid-round fault matrix.

Ports tests/test_precopy.py:67-325 to ``repro_torch`` (without :92 and
:105: the environment round trip and the deprecated keyword spellings
wait for the CLI).  Across the packages: ``TransferPolicy.to_spec`` and
``PrecopyController.decide`` give the reference's answers.  Then pre-copy
migration through the server and the trainer at smoke size, driven by the
reference orchestrator's loop (snapshot while running, wait for the
commit, push a round, observe, decide; on freeze a final image and the
residual round): the destination continues token-exact / bitwise against
a run that never migrated, and a trainer whose primary images are lost
restores from its replica bitwise.
"""
import dataclasses
import os
import shutil
import time

import numpy as np
import pytest
import torch

from repro.api import TransferPolicy as JaxTransferPolicy
from repro.transfer import PrecopyController as JaxPrecopyController
from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.api import TransferPolicy
from repro_torch.api.options import OptionsError
from repro_torch.chaos import hooks as chaos_hooks
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.core.snapshot_io import SnapshotStore
from repro_torch.runtime.server import DecodeServer
from repro_torch.runtime.trainer import TrainConfig, Trainer
from repro_torch.transfer import (ChunkStore, DeltaReplicator,
                                  PrecopyController, RoundDecision,
                                  summarize_rounds, transfer_closure)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(run_dir, steps=5, entries=6, entry_kb=64, seed=0):
    rng = np.random.default_rng(seed)
    state = {f"t{i}": torch.from_numpy(rng.integers(
        0, 8, size=entry_kb * 256).astype(np.float32))
        for i in range(entries)}
    s = CheckpointSession(run_dir, CheckpointOptions(mode="sync",
                                                     incremental=True),
                          device="cpu")
    s.attach(lambda: {"train_state": dict(state)})
    names = sorted(state)
    for step in range(1, steps + 1):
        if step > 1:
            for i in range(2):
                k = names[(step * 2 + i) % entries]
                state[k] = torch.from_numpy(rng.integers(
                    0, 8, size=entry_kb * 256).astype(np.float32))
        s.checkpoint(step)
    return state


def _restore_state(run_dir):
    s = CheckpointSession(run_dir, device="cpu")
    s.attach(lambda: {"train_state": None})
    return s.restore()["train_state"]


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------- TransferPolicy
def test_transfer_policy_validates():
    TransferPolicy().validate()
    p = TransferPolicy(mode="delta", precopy_rounds=4, max_blackout_ms=250.0)
    p.validate()
    assert p.precopy_enabled
    for bad in (dict(mode="rsync"),
                dict(mode="copy", precopy_rounds=2),
                dict(mode="delta", max_blackout_ms=100.0),
                dict(mode="delta", residual_bytes_cap=10),
                dict(workers=-1), dict(precopy_rounds=1.5)):
        with pytest.raises(OptionsError):
            TransferPolicy(**bad)


POLICIES = [dict(), dict(mode="delta"), dict(mode="delta", workers=2),
            dict(mode="delta", workers=2, precopy_rounds=8,
                 max_blackout_ms=500.0, residual_bytes_cap=1 << 20),
            dict(mode="delta", precopy_rounds=3, max_blackout_ms=100)]


@pytest.mark.parametrize("kw", POLICIES, ids=str)
def test_transfer_policy_spec_round_trip_matches_reference(kw):
    p = TransferPolicy(**kw)
    assert TransferPolicy.from_spec(p.to_spec()) == p
    assert p.to_spec() == JaxTransferPolicy(**kw).to_spec()
    assert p.to_dict() == JaxTransferPolicy(**kw).to_dict()
    if p.max_blackout_ms is None:
        assert "max_blackout_ms" not in p.to_spec()
    with pytest.raises(OptionsError):
        TransferPolicy.from_spec(p.to_spec() + ",speed=9")


def test_replicator_protocol_capabilities(tmp_path):
    from repro_torch.core.replication import (DirReplicator, MemReplicator,
                                              Replicator)
    for rep in (DirReplicator(str(tmp_path / "d")), MemReplicator()):
        assert isinstance(rep, Replicator)
        assert rep.supports_rounds is False
    rep = DeltaReplicator(str(tmp_path / "p"))
    assert isinstance(rep, Replicator)
    assert rep.supports_rounds is True


# ------------------------------------------------------------- controller
def test_controller_requires_precopy_policy():
    with pytest.raises(ValueError):
        PrecopyController(TransferPolicy(mode="delta"))


# (policy, rounds, expected action, reason fragment): the reference's
# controller cases (tests/test_precopy.py:145-186) and a few more
DECISIONS = [
    (dict(), [(1000, 0.1), (0, 0.01)], "freeze", "converged"),
    (dict(max_blackout_ms=500.0), [(10_000_000, 1.0), (1_000_000, 0.1)],
     "freeze", "blackout budget"),
    (dict(precopy_rounds=2, max_blackout_ms=0.001),
     [(1000, 0.1), (1000, 0.1)], "fallback", "round cap"),
    (dict(max_blackout_ms=0.001, residual_bytes_cap=1500),
     [(1000, 0.1), (1000, 0.1)], "fallback", "cap"),
    (dict(), [(1000, 0.1), (1000, 0.1)], "freeze", "stopped shrinking"),
    (dict(), [(2000, 0.2), (1000, 0.1)], "continue", "shrinking"),
    (dict(), [(1000, 0.1)], "continue", "shrinking"),
    (dict(precopy_rounds=4), [(2_259_192_355, 6.0), (402_661_000, 1.2),
                              (402_661_100, 1.1)], "freeze", "stopped"),
    (dict(max_blackout_ms=50.0), [(1000, 0.0)], "continue", "shrinking"),
]


@pytest.mark.parametrize("kw,rounds,action,reason", DECISIONS,
                         ids=[f"{a}-{i}" for i, (_k, _r, a, _s)
                              in enumerate(DECISIONS)])
def test_controller_decisions_match_reference(kw, rounds, action, reason):
    kw = dict(dict(mode="delta", precopy_rounds=8), **kw)
    ours = PrecopyController(TransferPolicy(**kw))
    ref = JaxPrecopyController(JaxTransferPolicy(**kw))
    for b, w in rounds:
        for c in (ours, ref):
            c.observe({"bytes_sent": b, "wall_s": w})
    d = ours.decide()
    assert isinstance(d, RoundDecision)
    assert d.action == action and reason in d.reason
    assert dataclasses.asdict(d) == dataclasses.asdict(ref.decide())
    if action == "freeze" and "budget" in reason:
        assert d.predicted_blackout_ms <= kw["max_blackout_ms"]


def test_controller_seed_skips_residual_rounds():
    c = PrecopyController(TransferPolicy(mode="delta", precopy_rounds=8))
    c.seed([{"bytes_sent": 1000, "wall_s": 0.1, "residual": False},
            {"bytes_sent": 200, "wall_s": 0.02, "residual": True}])
    assert len(c.rounds) == 1                        # residuals terminal


# ----------------------------------------------------------- round ledger
def test_round_ledger_persists_and_clears(tmp_path):
    store = ChunkStore(str(tmp_path / "cas"))
    assert store.round_state("mig") == []
    store.append_round("mig", {"round": 0, "bytes_sent": 10})
    store.append_round("mig", {"round": 1, "bytes_sent": 0})
    led = store.round_state("mig")
    assert [r["round"] for r in led] == [0, 1]
    assert all("t" in r for r in led)
    assert len(ChunkStore(str(tmp_path / "cas")).round_state("mig")) == 2
    store.clear_rounds("mig")
    assert store.round_state("mig") == []


def test_push_round_ships_only_deltas_and_records(tmp_path):
    src = str(tmp_path / "src")
    state = _chain(src)
    rep = DeltaReplicator(str(tmp_path / "peer"))
    closure = transfer_closure(SnapshotStore(src), 5)
    recs = [rep.push_round(src, s, "mig") for s in closure[:-1]]
    resid = rep.push_round(src, 5, "mig", residual=True)
    assert [r["round"] for r in recs + [resid]] == list(range(len(closure)))
    assert all(r["bytes_sent"] < recs[0]["bytes_sent"] + 1
               for r in recs[1:])
    assert resid["residual"] and resid["bytes_sent"] < recs[0]["bytes_sent"]
    summary = summarize_rounds(rep.round_state("mig"))
    assert summary["rounds_completed"] == len(closure) - 1
    assert summary["residual_bytes"] == resid["bytes_sent"]
    _assert_state_equal(_restore_state(str(tmp_path / "peer")), state)


# ------------------------------------------------- chaos migration matrix
class _Injector:
    """Fire `exc` on the Nth hit of `site` (or delay every hit)."""

    def __init__(self, site, nth, exc=None, delay_s=0.0):
        self.site, self.nth, self.exc, self.delay_s = site, nth, exc, delay_s
        self.hits = 0

    def on(self, site, **ctx):
        if site != self.site:
            return None
        self.hits += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.exc is not None and self.hits == self.nth:
            raise self.exc
        return None


@pytest.mark.parametrize("fault", ["none", "cas_partition", "degraded_io",
                                   "host_kill"])
def test_precopy_survives_midround_faults(tmp_path, fault):
    """A fault mid-round leaves the destination untorn and the migration
    resumable from the CAS round ledger: landed chunks are not re-sent,
    and the final image is bit-exact."""
    src = str(tmp_path / "src")
    state = _chain(src)
    peer = str(tmp_path / "peer")
    closure = transfer_closure(SnapshotStore(src), 5)
    tag = "mig"
    rep = DeltaReplicator(peer, workers=1)           # deterministic order
    if fault == "cas_partition":
        chaos_hooks.install(_Injector("cas.put", nth=3,
                                      exc=IOError("cas partition")))
        try:
            with pytest.raises(IOError, match="cas partition"):
                for s in closure[:-1]:
                    rep.push_round(src, s, tag)
        finally:
            chaos_hooks.uninstall()
        assert SnapshotStore(peer).list_steps() == []
        assert len(rep.round_state(tag)) == 0        # round never landed
    elif fault == "degraded_io":
        inj = _Injector("cas.put", nth=0, delay_s=0.002)
        chaos_hooks.install(inj)
        try:
            for s in closure[:-1]:
                rep.push_round(src, s, tag)
        finally:
            chaos_hooks.uninstall()
        assert inj.hits > 0
    elif fault == "host_kill":
        for s in closure[:2]:
            rep.push_round(src, s, tag)
        del rep
    else:
        for s in closure[:-1]:
            rep.push_round(src, s, tag)

    rep2 = DeltaReplicator(peer, workers=1)          # a fresh process
    ctrl = PrecopyController(TransferPolicy(mode="delta",
                                            precopy_rounds=16))
    ledger_before = rep2.round_state(tag)
    ctrl.seed(ledger_before)
    done = {r["step"] for r in ledger_before}
    reused = 0
    first_resumed_stats = None
    for s in closure[:-1]:
        if s in done:
            continue
        rec = rep2.push_round(src, s, tag)
        if first_resumed_stats is None:
            first_resumed_stats = dict(rep2.stats)
        reused += rec["chunks_reused"]
    resid = rep2.push_round(src, 5, tag, residual=True)
    if fault == "cas_partition":
        assert reused > 0
    if fault == "host_kill":
        assert first_resumed_stats["steps_skipped"] >= 2
        assert resid["round"] == len(rep2.round_state(tag)) - 1
        assert len(ledger_before) == 2
    _assert_state_equal(_restore_state(peer), state)
    assert SnapshotStore(peer).list_steps() == closure


# ------------------------------------- migration of a server and a trainer
ARCH = "qwen1.5-0.5b"
POLICY = TransferPolicy(mode="delta", precopy_rounds=4)


def _precopy(job, advance, rep, tag="mig"):
    """The reference orchestrator's pre-copy loop
    (src/repro/orchestrator/orchestrator.py:476-531, the residual at
    :581-592): the job advances, snapshots while running and ships a
    round until the controller says freeze or fall back; then the job
    advances once more, is frozen by a checkpoint-on-signal and the
    residual round ships.  Returns the decisions and the final step."""
    ctrl = PrecopyController(POLICY)
    run, sess = job.session.run_dir, job.session
    actions = []
    while True:
        advance()
        if actions and actions[-1] != "continue":
            step = job.preempt_now()
            sess.wait_pending()
            rep.push_round(run, step, tag, residual=True)
            break
        step = job.pos if hasattr(job, "pos") else job.step
        sess.checkpoint_running(step)
        sess.wait_pending()
        ctrl.observe(rep.push_round(run, step, tag))
        actions.append(ctrl.decide().action)
    summary = summarize_rounds(rep.round_state(tag))
    rep.clear_rounds(tag)
    return actions, step, summary


class _ServerJob:
    def __init__(self, srv):
        self.srv, self.session = srv, srv.session

    @property
    def pos(self):
        return self.srv.pos

    def preempt_now(self):
        out = self.srv.decode_until(self.srv.pos + 1, preempt=lambda: True)
        assert out["preempted"] and out["steps"] == 0
        return self.srv.pos


def test_server_precopy_migration_continues_token_exact(tmp_path):
    """(c) at smoke size: rounds shrink after the first (the params land
    once), stop shrinking at round 2 (the cache changes whole), freeze;
    the destination's server continues token-exact against one that
    never migrated."""
    cfg = get_smoke_config(ARCH)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    src, dest = str(tmp_path / "src"), str(tmp_path / "dest")
    srv = DecodeServer(cfg, src, max_seq=64, device="cpu",
                       options=CheckpointOptions(mode="async",
                                                 incremental=True))
    params = srv.model.init(0)
    srv.load(params)
    srv.start({"tokens": prompt})
    rep = DeltaReplicator(dest)
    actions, step, summary = _precopy(_ServerJob(srv),
                                      lambda: srv.decode(4), rep)
    assert actions == ["continue", "continue", "freeze"]
    assert summary["rounds_completed"] == 3
    assert 0 < summary["residual_bytes"] < summary["precopy_bytes"] / 2
    assert step == srv.pos == 8 + 4 * 4
    ref = DecodeServer(cfg, str(tmp_path / "ref"), max_seq=64, device="cpu")
    ref.load(params)
    ref.start({"tokens": prompt})
    ref.decode_until(step)
    fresh = DecodeServer(cfg, dest, max_seq=64, device="cpu")
    assert fresh.restore() == step
    assert np.array_equal(fresh.decode(4), ref.decode(4))


TCFG = dict(batch_size=2, seq_len=16, total_steps=10, warmup_steps=2,
            seed=0, compute_dtype=torch.float32, remat=False)


def _trainer(run, ckpt_every=0, **ckpt):
    tcfg = TrainConfig(**TCFG, ckpt_every=ckpt_every,
                       ckpt=CheckpointOptions(**ckpt))
    return Trainer(get_smoke_config(ARCH), tcfg, run, device="cpu")


def _same_training(a, b):
    if a.metrics_history["loss"] != b.metrics_history["loss"]:
        return False
    for tree in ("params", "opt_state"):
        x, y = (flatten_with_paths(getattr(t, tree)) for t in (a, b))
        if x.keys() != y.keys() or not all(torch.equal(x[k], y[k])
                                           for k in x):
            return False
    return True


class _TrainJob:
    def __init__(self, t):
        self.t, self.session = t, t.session

    @property
    def step(self):
        return self.t.step

    def preempt_now(self):
        out = self.t.run_until(self.t.step + 1, preempt=lambda: True)
        assert out["preempted"] and out["steps"] == 0
        return self.t.step


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """10 uninterrupted steps, replicating async delta images every 5."""
    root = tmp_path_factory.mktemp("train")
    run, peer = str(root / "run"), str(root / "peer")
    t = _trainer(run, ckpt_every=5, mode="async", incremental=True,
                 replicate_to=peer,
                 transfer_policy=TransferPolicy(mode="delta"))
    t.run(10)
    return t, run, peer


def test_trainer_precopy_migration_resumes_bitwise(tmp_path, reference_run):
    """(d) at smoke size: AdamW rewrites every leaf, so after the first
    round (which also ships the image's metadata) the rounds stop
    shrinking and the controller freezes; the residual is a whole image.
    The destination's trainer resumes at step 8 and ends at step 10
    bitwise at the uninterrupted run's losses, params, m and v."""
    ref = reference_run[0]
    src, dest = str(tmp_path / "src"), str(tmp_path / "dest")
    t = _trainer(src, mode="async", incremental=True)
    t.initialize()
    rep = DeltaReplicator(dest)
    actions, step, summary = _precopy(_TrainJob(t),
                                      lambda: t.run_until(t.step + 2), rep)
    assert actions == ["continue", "continue", "freeze"] and step == 8
    assert summary["residual_bytes"] >= 0.99 * summary["precopy_bytes"] / 3
    fresh = _trainer(dest)
    assert fresh.restore() == step
    fresh.run_until(10)
    assert _same_training(fresh, ref)


def test_trainer_restores_from_replica_after_primary_loss(reference_run):
    ref, run, peer = reference_run
    shutil.rmtree(os.path.join(run, "snapshots"))
    t = _trainer(run, replicate_to=peer,
                 transfer_policy=TransferPolicy(mode="delta"))
    assert t.restore() == 10
    assert t.session.last_stats["restored_from_replica"] is True
    assert _same_training(t, ref)

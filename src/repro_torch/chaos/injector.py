"""The fault injector: matches hook firings against a seeded plan.

One :class:`FaultInjector` is installed (``hooks.install``) for the
duration of a campaign.  Hook sites call :meth:`on`, which dispatches to
a per-site handler; handlers consult the plan's pending events and, when
a trigger condition is met, mutate real state — flip a byte in a pack
stripe, raise where a kill would land, corrupt a CAS object on disk,
duplicate or defer a signal — then record the injection in an audit
trail the campaign evaluates afterwards.

Trigger conditions anchor on *job progress* (``rec.step``, commit step),
never on wall-clock or tick numbers, so the same seed reproduces the
same injections regardless of machine speed.

Thread-safety: the orchestrator loop is single-threaded, but pack stripe
appenders and transfer lanes run in worker threads; every handler that
mutates event state takes ``self.lock``.

A port of the JAX package's injector.  What it adds: ``dirty_burst``
mutates a live ``torch.Tensor`` (on the CPU or on a card) as well as a
numpy array, flipping one byte in place through a ``uint8`` view.  On a
card each flip is waited for before the handler returns, so it is
ordered before any copy issued after it, whatever stream that copy runs
on: the speculated copy of the entry holds the flipped byte, and the
validate pause's recapture (in ``dump.patch``) reads the reverted one.
"""
from __future__ import annotations

import contextlib
import glob
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import journal as obs_journal
from repro_torch.obs import metrics as obs_metrics
from repro_torch.orchestrator.job import JobState
from repro_torch.orchestrator.signals import Signal

from . import hooks
from .plan import (ChaosConfig, ChaosInjectedFault, ChaosPartition,
                   FaultEvent)

# Events driven from the orchestrator tick (vs. fired inside commits).
DRIVER_KINDS = ("host_kill", "exhaust", "eviction_wall",
                "signal_dup", "signal_delay")


def _numel(leaf) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else leaf.size


def _device_of(leaf) -> str:
    """Where a mutated leaf lived: a tensor's device, or "numpy"."""
    return str(leaf.device) if isinstance(leaf, torch.Tensor) else "numpy"


def _flip_first_byte(leaf) -> None:
    """XOR the first byte of a contiguous leaf with 0xFF, in place (its
    own inverse).  A CUDA flip is waited for before returning."""
    if isinstance(leaf, np.ndarray):
        leaf.view(np.uint8).reshape(-1)[0] ^= 0xFF
        return
    with torch.no_grad():
        # view() (not reshape) raises on a non-contiguous leaf instead of
        # silently flipping a copy
        leaf.view(torch.uint8).view(-1)[:1].bitwise_xor_(0xFF)
    if leaf.is_cuda:
        torch.cuda.current_stream(leaf.device).synchronize()


def _flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([(b[0] if b else 0) ^ 0xFF]))


class FaultInjector:
    def __init__(self, config: ChaosConfig, clock=time.monotonic):
        self.config = config
        self.clock = clock
        self.lock = threading.RLock()
        self.injections: List[Dict] = []     # audit trail, in fire order
        # job context, maintained by the sim.* hooks (the orchestrator
        # runs jobs serially, so this is stable across one slice/commit)
        self.current_job: Optional[str] = None
        self.current_ckpt_step: Optional[int] = None
        self._deferred: List[Dict] = []      # delayed signal deliveries
        self._tick = 0

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def installed(self):
        hooks.install(self)
        try:
            yield self
        finally:
            hooks.uninstall()

    def on(self, site: str, **ctx: Any) -> Any:
        h = getattr(self, "_on_" + site.replace(".", "_"), None)
        return h(**ctx) if h is not None else None

    def injected_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.injections:
            out[rec["kind"]] = out.get(rec["kind"], 0) + 1
        return out

    # -- bookkeeping ----------------------------------------------------
    def _audit(self, rec: Dict[str, Any]) -> None:
        """Every injection lands in the audit trail *and* the run journal
        (cls="fault"), so ``python -m repro_torch events --class fault``
        lines injected faults up against the incident spans they caused.
        The journal is a side channel: campaign fingerprints hash the
        audit trail only, so observability never perturbs a seeded
        campaign."""
        self.injections.append(rec)
        obs_metrics.counter_add("chaos.injections")
        # the record's "t" is the injector's clock; the journal's own "t"
        # (journal-relative, what the exporters sort and place by) stays,
        # and the injection time travels as t_injected
        obs_journal.emit("fault", rec["kind"], t_injected=rec["t"],
                         **{k: v for k, v in rec.items()
                            if k not in ("kind", "t")})

    def _record(self, ev: FaultEvent, **extra: Any) -> None:
        ev.state = "injected"
        ev.t_injected = self.clock()
        ev.injected_step = extra.get("step")
        self._audit({
            "kind": ev.kind, "job": ev.job_id, "seq": ev.seq,
            "at_step": ev.at_step, "t": ev.t_injected, **extra})

    def _match_commit(self, kind: str) -> Optional[FaultEvent]:
        """Pending event of `kind` triggered by the commit in progress."""
        job, step = self.current_job, self.current_ckpt_step
        if job is None or step is None:
            return None
        for ev in self.config.events:
            if (ev.kind == kind and ev.state == "pending"
                    and ev.job_id == job and step >= ev.at_step):
                return ev
        return None

    # -- sim workload context -------------------------------------------
    def _on_sim_slice(self, job_id, step=None, **_):
        with self.lock:
            self.current_job = job_id
            self.current_ckpt_step = None

    def _on_sim_checkpoint(self, job_id, step, **_):
        with self.lock:
            self.current_job = job_id
            self.current_ckpt_step = step

    def _on_sim_restore(self, job_id, **_):
        with self.lock:
            self.current_job = job_id
            self.current_ckpt_step = None

    def _on_sim_step(self, job_id, step, **_):
        """degraded_io: return a per-step delay (seconds) or None."""
        with self.lock:
            for ev in self.config.events:
                if (ev.kind == "degraded_io" and ev.job_id == job_id
                        and ev.state in ("pending", "injected")):
                    window = ev.detail.get("window", 4)
                    if ev.at_step <= step < ev.at_step + window:
                        if ev.state == "pending":
                            self._record(ev, step=step)
                        return ev.detail.get("delay_s", 0.12)
        return None

    # -- dump path ------------------------------------------------------
    def _on_pack_chunk(self, file, offset, data, dtype=None, **_):
        """torn_write: flip one byte of a freshly written array chunk."""
        if dtype is None:        # only corrupt per-step array payloads
            return None
        with self.lock:
            ev = self._match_commit("torn_write")
            if ev is None:
                return None
            pos = file.tell()
            file.seek(offset)
            file.write(bytes([data[0] ^ 0xFF]))
            file.seek(pos)
            self._record(ev, step=self.current_ckpt_step, offset=offset)
        return None

    def _on_snapshot_pre_manifest(self, step, path, **_):
        """commit_kill: die after payload rename, before MANIFEST."""
        with self.lock:
            ev = self._match_commit("commit_kill")
            if ev is None:
                return None
            self._record(ev, step=step, path=path)
        raise ChaosInjectedFault(
            f"chaos: killed mid-commit (phase-2 payload on disk, "
            f"no manifest) for step {step}")

    def _on_engine_dump_done(self, run_dir, step, path, **_):
        """fsync_drop: corrupt the committed local image post-push."""
        with self.lock:
            ev = self._match_commit("fsync_drop")
            if ev is None:
                return None
            packs = sorted(glob.glob(os.path.join(path, "*.pack*")),
                           key=os.path.getsize, reverse=True)
            if not packs:
                return None
            target = packs[0]
            size = os.path.getsize(target)
            _flip_byte(target, max(16, size // 3))
            ev.state = "armed"       # follow-up kill from _on_orch_tick
            ev.t_injected = self.clock()
            ev.injected_step = step
            self._audit({
                "kind": ev.kind, "job": ev.job_id, "seq": ev.seq,
                "at_step": ev.at_step, "t": ev.t_injected,
                "step": step, "path": target})
        return None

    # -- concurrent (soft-freeze) capture --------------------------------
    def _on_engine_speculate(self, key, leaf, note, step=None, **_):
        """dirty_burst: mutate a live leaf mid-speculation.

        Models the step loop racing the snapshot: the leaf's bytes change
        after the pin, and — exactly like a retiring stream op — the
        mutation is signalled through the dirty protocol via ``note``.
        The validate pause must re-hash the entry, spot the stale
        speculated copy, and re-capture it; the mutation is reverted at
        the validate site so the job's own trajectory stays bit-exact.
        """
        if not isinstance(leaf, (np.ndarray, torch.Tensor)) or \
                _numel(leaf) == 0:
            return None
        with self.lock:
            ev = self._match_commit("dirty_burst")
            if ev is None:
                return None
            try:
                _flip_first_byte(leaf)
            except (ValueError, AttributeError, RuntimeError):
                return None          # non-contiguous / read-only leaf
            note(key)
            ev.state = "armed"       # reverted+recorded at engine.validate
            ev.detail["mutated"] = {"key": key, "leaf": leaf}
        return None

    def _on_engine_validate(self, step=None, **_):
        """Revert armed dirty_burst mutations at the commit point."""
        with self.lock:
            for ev in self.config.events:
                if (ev.kind != "dirty_burst" or ev.state != "armed"
                        or ev.job_id != self.current_job):
                    continue
                mut = ev.detail.pop("mutated", None)
                extra: Dict[str, Any] = {"key": None}
                if mut is not None:
                    _flip_first_byte(mut["leaf"])
                    extra = {"key": mut["key"],
                             "device": _device_of(mut["leaf"])}
                self._record(ev, step=step, **extra)
        return None

    # -- transfer path --------------------------------------------------
    def _on_cas_put(self, key, nbytes=0, **_):
        """cas_partition: cut the host off from the CAS mid-push."""
        with self.lock:
            ev = self._match_commit("cas_partition")
            if ev is None:
                return None
            landed = ev.detail.setdefault("puts_before_cut", 1)
            if landed > 0:
                ev.detail["puts_before_cut"] = landed - 1
                return None
            self._record(ev, step=self.current_ckpt_step, key=key)
        raise ChaosPartition(
            f"chaos: host partitioned from CAS while putting {key}")

    def _on_cas_landed(self, key, path, **_):
        """cas_corrupt: corrupt the object on disk right after it lands."""
        with self.lock:
            ev = self._match_commit("cas_corrupt")
            if ev is None:
                return None
            size = os.path.getsize(path)
            _flip_byte(path, max(0, size // 2))
            self._record(ev, step=self.current_ckpt_step, key=key)
        return None

    # -- fleet path -----------------------------------------------------
    def _on_fleet_boot(self, replica, host=None, **_):
        """host_kill at a fleet boot site: the replica's host dies
        mid-boot.  Matches a pending host_kill targeting the replica id
        or (via ``detail={"host": ...}``) the whole simulated host; the
        fleet quarantines the dead replica and keeps serving."""
        with self.lock:
            for ev in self.config.events:
                if (ev.kind == "host_kill" and ev.state == "pending"
                        and (ev.job_id == replica
                             or ev.detail.get("host") == host)):
                    self._record(ev, replica=replica, host=host)
                    break
            else:
                return None
        raise ChaosInjectedFault(
            f"chaos: host {host} killed while booting replica {replica}")

    # -- signal path ----------------------------------------------------
    def _on_signal_send(self, channel, job_id, sig, **_):
        """Armed signal events: duplicate or defer this delivery."""
        with self.lock:
            for ev in self.config.events:
                if ev.state != "armed" or ev.job_id != job_id:
                    continue
                if ev.kind == "signal_dup":
                    # one extra copy now; the normal path appends the
                    # original, so the job sees the signal twice.
                    channel._pending.setdefault(job_id, []).append(sig)
                    channel.sent.append((job_id, sig))
                    self._record(ev, sig=str(sig.value))
                    return None
                if ev.kind == "signal_delay":
                    self._deferred.append({
                        "channel": channel, "job_id": job_id, "sig": sig,
                        "due": self._tick + 2})
                    self._record(ev, sig=str(sig.value))
                    return "defer"
        return None

    # -- orchestrator driver --------------------------------------------
    def _on_orch_tick(self, orch, tick, **_):
        with self.lock:
            self._tick = tick
            self._deliver_due(tick)
            for ev in self.config.events:
                rec = orch.records.get(ev.job_id)
                if rec is None:
                    continue
                # a crashed job stays RUNNING until the heartbeat deadline
                # but its workload is gone: a signal sent into that window
                # is dropped by the eviction's channel.unregister, so only
                # target jobs that are actually alive
                alive = (rec.state == JobState.RUNNING
                         and ev.job_id in orch.workloads)
                if ev.state == "pending" and ev.kind in DRIVER_KINDS:
                    if alive and rec.step >= ev.at_step:
                        self._trigger(ev, orch, rec)
                elif ev.state == "armed" and ev.kind == "fsync_drop":
                    if alive:
                        orch.channel.send(ev.job_id, Signal.KILL)
                        ev.state = "injected"
                elif ev.state == "armed" and ev.kind == "exhaust":
                    if alive and rec.step >= ev.at_step:
                        orch.channel.send(ev.job_id, Signal.KILL)
                        left = ev.detail.get("kills_left", 0) - 1
                        ev.detail["kills_left"] = left
                        if left <= 0:
                            ev.state = "injected"
        return None

    def _deliver_due(self, tick):
        for d in list(self._deferred):
            if tick >= d["due"]:
                ch, job, sig = d["channel"], d["job_id"], d["sig"]
                # replicate SignalChannel.send without re-firing the hook
                ch._pending.setdefault(job, []).append(sig)
                ch.sent.append((job, sig))
                handler = ch._handlers.get(job)
                if handler is not None:
                    handler(sig)
                self._deferred.remove(d)

    def _trigger(self, ev: FaultEvent, orch, rec) -> None:
        if ev.kind == "host_kill":
            host = rec.host
            if host is None:        # single-host fleet: kill the target
                victims = [ev.job_id]
            else:
                victims = [j for j, r in orch.records.items()
                           if r.state == JobState.RUNNING
                           and j in orch.workloads and r.host == host]
            for j in victims:
                orch.channel.send(j, Signal.KILL)
            self._record(ev, step=rec.step, host=host,
                         victims=sorted(victims))
        elif ev.kind == "exhaust":
            orch.channel.send(ev.job_id, Signal.KILL)
            ev.state = "armed"       # second kill from _on_orch_tick
            ev.detail["kills_left"] = 1
            ev.t_injected = self.clock()
            ev.injected_step = rec.step
            self._audit({
                "kind": ev.kind, "job": ev.job_id, "seq": ev.seq,
                "at_step": ev.at_step, "t": ev.t_injected,
                "step": rec.step})
        elif ev.kind == "eviction_wall":
            from repro_torch.orchestrator.orchestrator import MigrationPlan
            # _migrate picks the destination host via Scheduler.place
            orch.migrations[ev.job_id] = MigrationPlan(
                job_id=ev.job_id, at_step=rec.step, src_host=rec.host)
            self._record(ev, step=rec.step, src_host=rec.host)
        elif ev.kind in ("signal_dup", "signal_delay"):
            ev.state = "armed"       # _on_signal_send completes it
            orch.channel.send(ev.job_id, Signal.PREEMPT)

"""Snapshot-fork serving fleet: N decode replicas from one image.

The serving-scale consequence of transparent device snapshots (the paper's
"significantly reduce recovery times" claim, pushed to the multi-tenant
GPU-sharing setting of the MPS/PhoenixOS line in PAPERS.md): one
committed :class:`~repro_torch.runtime.server.DecodeServer` image fans out
into K replicas cheaply because every piece of the restore path is
content-addressed and lazy.

  * one **source image**: a solo server prefills + decodes a few tokens
    and commits — that snapshot is the fleet's only artifact;
  * **delta-replicate once per host**: each simulated host owns a shared
    CAS (:func:`~repro_torch.orchestrator.workloads.host_cas_dir`); the first
    replica on a host pays the cold chunk fill, every later replica
    negotiates have/want against the warm CAS and ships ~0 new bytes —
    total restore bytes grow sub-linearly in K;
  * **lazy cold boot**: each replica restores with the params-only
    critical set and decodes its first token while the KV cache streams
    behind it (the resume-before-read story, per replica);
  * **per-replica TTFT**: every boot is one
    :class:`~repro_torch.orchestrator.recovery.RecoveryLog` incident
    (transfer -> schedule -> restore -> first token) and one
    ``fleet.boot`` span, so ``repro trace`` shows the fan-out timeline.

:meth:`ServingFleet.serve_trace` then drives a deterministic bursty
request trace with autoscale-on-queue-depth: a queue spike boots another
replica (through the same measured path), sustained idle drains one.

All replicas share one model object (it holds no weights; each replica
restores its own).  The fleet runs on ``device``: ``cuda`` unless the
caller passes ``"cpu"``.  ``FleetConfig.workload`` (a
:class:`~repro_torch.orchestrator.workloads.WorkloadConfig`) sets the
model, its compute dtype and whether it runs the hand-written kernels;
without it the fleet serves ``arch``'s smoke config in f32, as the JAX
package's does.  The serve shape is the fleet's own (``batch``,
``prompt_len``, ``max_seq``).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api import CheckpointOptions
from repro_torch.chaos import hooks
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.obs import journal as obs_journal
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.orchestrator.recovery import RecoveryLog
from repro_torch.orchestrator.workloads import (WorkloadConfig, host_cas_dir,
                                                job_dir_for)


@dataclass
class FleetConfig:
    """Knobs for one fleet run (the JAX package's, plus ``workload``)."""

    replicas: int = 8                 # initial fan-out target
    hosts: int = 2                    # simulated hosts (one CAS each)
    restore_mode: str = "lazy"        # "lazy" (params-critical) | "eager"
    arch: str = "qwen1.5-0.5b"
    batch: int = 2                    # prompt batch baked into the image
    prompt_len: int = 8
    warm_tokens: int = 4              # decoded before the image commits
    max_seq: int = 64
    seed: int = 0
    tokens_per_request: int = 4       # decode work per served request
    scale_up_depth: int = 2           # queue > depth*serving -> boot one
    drain_idle_ticks: int = 2         # idle ticks before draining one
    min_replicas: int = 1
    max_replicas: int = 64
    workload: Optional[WorkloadConfig] = None   # model, dtype, kernels


@dataclass
class Replica:
    rid: str
    host: str
    status: str = "booting"           # booting|serving|dead|drained
    ttft_s: Optional[float] = None
    diagnosis: Optional[str] = None
    transfer: Dict[str, Any] = field(default_factory=dict)
    served_requests: int = 0
    served_tokens: int = 0
    autoscaled: bool = False
    server: Any = None
    recovery: Optional[RecoveryLog] = None


class ServingFleet:
    """K decode replicas forked from one committed image."""

    def __init__(self, run_dir: str, config: Optional[FleetConfig] = None,
                 device: DeviceLike = None):
        from repro_torch.configs import get_smoke_config
        self.run_dir = run_dir
        self.config = config or FleetConfig()
        self.device = resolve_device(device)
        w = self.config.workload or WorkloadConfig(
            model=get_smoke_config(self.config.arch))
        self.cfg = w.model_config()
        # one model object, K replicas
        self.model = w.build_model(self.device)
        self.replicas: List[Replica] = []
        self.source = None                  # the solo (unforked) server
        self.source_dir = os.path.join(run_dir, "source")
        self.image_step: Optional[int] = None
        self.image_bytes: int = 0
        self.serve_stats: Dict[str, Any] = {}
        self._rr_host = 0

    # ---------------------------------------------------------- image
    def _options(self) -> CheckpointOptions:
        return CheckpointOptions(restore_mode=self.config.restore_mode)

    def _make_server(self, run_dir: str):
        from repro_torch.runtime.server import DecodeServer
        return DecodeServer(self.cfg, run_dir, max_seq=self.config.max_seq,
                            options=self._options(), device=self.device,
                            model=self.model)

    def build_source_image(self) -> Dict[str, Any]:
        """Boot the solo server, warm it, commit the fleet's one image."""
        c = self.config
        srv = self._make_server(self.source_dir)
        rng = np.random.default_rng(c.seed)
        prompt = rng.integers(1, self.cfg.vocab_size,
                              size=(c.batch, c.prompt_len)).astype(np.int32)
        srv.load(self.model.init(c.seed))
        srv.start({"tokens": prompt})
        srv.decode(c.warm_tokens)
        srv.checkpoint(srv.pos)
        srv.session.wait_pending()
        self.source = srv
        self.image_step = srv.pos
        self.image_bytes = _dir_bytes(self._image_dir())
        obs_journal.emit("fleet", "image_committed", step=self.image_step,
                         bytes=self.image_bytes)
        return {"step": self.image_step, "bytes": self.image_bytes}

    def _image_dir(self) -> str:
        from repro_torch.core.snapshot_io import snapshot_dir
        return snapshot_dir(self.source_dir, self.image_step)

    # ---------------------------------------------------------- boot
    def _next_host(self) -> str:
        host = f"h{self._rr_host % max(1, self.config.hosts)}"
        self._rr_host += 1
        return host

    def boot_replica(self, host: Optional[str] = None,
                     autoscaled: bool = False) -> Replica:
        """Fork one replica from the image: push -> cold restore -> first
        token.  The whole window is one ``fleet.boot`` span and one
        RecoveryLog incident whose ``total_s`` is the replica's TTFT."""
        if self.image_step is None:
            raise RuntimeError("build_source_image() first")
        from repro_torch.transfer import DeltaReplicator
        rid = f"r{len(self.replicas):03d}"
        host = host if host is not None else self._next_host()
        rep = Replica(rid=rid, host=host, autoscaled=autoscaled)
        rep.recovery = RecoveryLog(job_id=rid)
        self.replicas.append(rep)
        rep_dir = job_dir_for(self.run_dir, rid, host)
        t0 = time.perf_counter()
        rep.recovery.open("fleet_boot", t0, t0,
                          step_at_interrupt=self.image_step,
                          last_ckpt_step=self.image_step)
        obs_metrics.counter_add("fleet.replicas_booted")
        try:
            with obs_trace.span("fleet.boot", replica=rid, host=host,
                                autoscaled=autoscaled) as sp:
                if hooks.INJECTOR is not None:
                    hooks.fire("fleet.boot", replica=rid, host=host)
                # one push per replica; the host CAS makes every push
                # after the host's first a ~0-byte negotiation
                t1 = time.perf_counter()
                stats = DeltaReplicator(
                    rep_dir, cas_dir=host_cas_dir(self.run_dir, host)
                ).push(self.source_dir, self.image_step)
                t2 = time.perf_counter()
                rep.transfer = stats
                rep.recovery.mark_transfer(
                    t1, t2, bytes_sent=stats["bytes_sent"],
                    chunks_reused=stats["chunks_reused"])
                obs_metrics.counter_add("fleet.restore_bytes",
                                        float(stats["bytes_sent"]))
                rep.recovery.mark_scheduled(t2)
                rep.server = self._make_server(rep_dir)
                rep.server.restore(step=self.image_step)
                t3 = time.perf_counter()
                rep.recovery.mark_restored(t3, self.image_step)
                rep.server.decode(1)          # first token (joins lazy)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t4 = time.perf_counter()
                rep.recovery.mark_caught_up(t4)
                rep.recovery.mark_materialized(t4)
                rep.ttft_s = t4 - t0
                rep.status = "serving"
                sp.set(ttft_s=rep.ttft_s,
                       bytes_sent=stats["bytes_sent"])
        except Exception as e:                      # noqa: BLE001
            # a dead boot quarantines the replica, not the fleet: the
            # diagnosis is the audit record chaos tests assert on
            rep.status = "dead"
            rep.diagnosis = f"{type(e).__name__}: {e}"
            if rep.server is not None:
                rep.server.release()
            rep.server = None
            obs_journal.emit("fleet", "boot_failed", replica=rid,
                             host=host, diagnosis=rep.diagnosis)
        else:
            obs_metrics.observe("fleet.ttft_s", rep.ttft_s)
            obs_journal.emit("fleet", "replica_boot", replica=rid,
                             host=host, ttft_s=rep.ttft_s,
                             bytes_sent=stats["bytes_sent"])
        obs_metrics.gauge_set("fleet.replicas_serving",
                              float(len(self.serving())))
        return rep

    def boot_fleet(self, n: Optional[int] = None) -> List[Replica]:
        for _ in range(n if n is not None else self.config.replicas):
            self.boot_replica()
        return self.replicas

    # ---------------------------------------------------------- queries
    def serving(self) -> List[Replica]:
        return [r for r in self.replicas if r.status == "serving"]

    def quarantined(self) -> List[Replica]:
        return [r for r in self.replicas if r.status == "dead"]

    # ---------------------------------------------------------- serving
    def _has_capacity(self, rep: Replica) -> bool:
        return (rep.server.pos + self.config.tokens_per_request
                <= rep.server.max_seq)

    def _drain(self, rep: Replica, reason: str) -> None:
        rep.status = "drained"
        rep.diagnosis = reason
        rep.server.release()
        rep.server = None
        obs_journal.emit("fleet", "replica_drained", replica=rep.rid,
                         reason=reason)
        obs_metrics.gauge_set("fleet.replicas_serving",
                              float(len(self.serving())))

    def serve_trace(self, trace: List[int],
                    max_drain_ticks: int = 200) -> Dict[str, Any]:
        """Drive a deterministic bursty request trace against the fleet.

        ``trace[i]`` requests arrive at tick ``i``; each serving replica
        completes at most one request (``tokens_per_request`` decoded
        tokens) per tick.  Queue depth above ``scale_up_depth x serving``
        boots one replica that tick; ``drain_idle_ticks`` consecutive
        empty-queue ticks drain one (never below ``min_replicas``).
        After the trace the loop keeps ticking until the queue is empty.

        Goodput here is deterministic — requests served per
        replica-tick of capacity — so the bench row is seed-stable.
        """
        c = self.config
        pending = 0
        served = 0
        idle_ticks = 0
        replica_ticks = 0
        autoscale_boots = 0
        drains = 0
        ticks = 0
        with obs_trace.span("fleet.serve", replicas=len(self.replicas),
                            trace_ticks=len(trace)) as sp:
            arrivals_iter = list(trace)
            while arrivals_iter or pending > 0:
                arrivals = arrivals_iter.pop(0) if arrivals_iter else 0
                ticks += 1
                if not arrivals_iter and ticks > len(trace) \
                        + max_drain_ticks:
                    break                       # wedged fleet backstop
                pending += arrivals
                live = self.serving()
                # scale up on spike: one measured boot per tick
                if (pending > c.scale_up_depth * max(1, len(live))
                        and len(live) < c.max_replicas):
                    rep = self.boot_replica(autoscaled=True)
                    if rep.status == "serving":
                        autoscale_boots += 1
                        live = self.serving()
                # dispatch: one request per serving replica per tick
                for rep in live:
                    if pending == 0:
                        break
                    if not self._has_capacity(rep):
                        self._drain(rep, "max_seq reached")
                        drains += 1
                        continue
                    rep.server.decode(c.tokens_per_request)
                    rep.served_requests += 1
                    rep.served_tokens += c.tokens_per_request
                    pending -= 1
                    served += 1
                replica_ticks += len(self.serving())
                # scale down on sustained idle
                idle_ticks = idle_ticks + 1 if pending == 0 else 0
                if idle_ticks >= c.drain_idle_ticks:
                    live = self.serving()
                    if len(live) > c.min_replicas:
                        self._drain(live[-1], "idle")
                        drains += 1
                    idle_ticks = 0
            goodput = served / replica_ticks if replica_ticks else 0.0
            sp.set(served=served, ticks=ticks, goodput=goodput)
        obs_metrics.counter_add("fleet.requests_served", float(served))
        self.serve_stats = {
            "requests_arrived": int(sum(trace)),
            "requests_served": served,
            "requests_unserved": pending,
            "ticks": ticks,
            "replica_ticks": replica_ticks,
            "goodput_requests_per_replica_tick": goodput,
            "autoscale_boots": autoscale_boots,
            "drains": drains,
        }
        return self.serve_stats

    # ---------------------------------------------------------- report
    def summary(self) -> Dict[str, Any]:
        ttfts = sorted(r.ttft_s for r in self.replicas
                       if r.ttft_s is not None)
        total_sent = sum(r.transfer.get("bytes_sent", 0)
                         for r in self.replicas)
        total_reused = sum(r.transfer.get("bytes_reused", 0)
                           for r in self.replicas)
        hosts: Dict[str, Dict[str, Any]] = {}
        for r in self.replicas:
            h = hosts.setdefault(r.host, {"replicas": 0, "bytes_sent": 0})
            h["replicas"] += 1
            h["bytes_sent"] += r.transfer.get("bytes_sent", 0)
        # cross-check our accounting against each host CAS's own
        # transfer log (the store records every push it served)
        from repro_torch.transfer import ChunkStore
        for h, agg in hosts.items():
            cas = host_cas_dir(self.run_dir, h)
            if os.path.isdir(cas):
                agg["cas_log_bytes_sent"] = sum(
                    t.get("bytes_sent", 0)
                    for t in ChunkStore(cas).transfer_log())
        denom = total_sent + total_reused
        out = {
            "replicas": len(self.replicas),
            "serving": len(self.serving()),
            "dead": len(self.quarantined()),
            "drained": len([r for r in self.replicas
                            if r.status == "drained"]),
            "hosts": hosts,
            "image_step": self.image_step,
            "image_bytes": self.image_bytes,
            "total_restore_bytes": total_sent,
            "restore_bytes_per_replica": (total_sent / len(self.replicas)
                                          if self.replicas else 0.0),
            "restore_bytes_vs_image": (total_sent / self.image_bytes
                                       if self.image_bytes else 0.0),
            "dedup_ratio": (total_reused / denom) if denom else 0.0,
            "ttft_p50_s": _pct(ttfts, 0.50),
            "ttft_p99_s": _pct(ttfts, 0.99),
            "ttft_first_s": ttfts[0] if ttfts else None,
            "per_replica": [{
                "rid": r.rid, "host": r.host, "status": r.status,
                "ttft_s": r.ttft_s, "diagnosis": r.diagnosis,
                "autoscaled": r.autoscaled,
                "bytes_sent": r.transfer.get("bytes_sent"),
                "chunks_reused": r.transfer.get("chunks_reused"),
                "served_requests": r.served_requests,
                "recovery": (r.recovery.breakdown()
                             if r.recovery else []),
            } for r in self.replicas],
        }
        out.update(self.serve_stats)
        return out


def _pct(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


def run_fleet(run_dir: str, config: Optional[FleetConfig] = None,
              trace: Optional[List[int]] = None,
              device: DeviceLike = None) -> Dict[str, Any]:
    """One-call scenario: image -> K replicas -> bursty trace -> summary.

    ``trace=None`` picks a deterministic burst shaped to the fleet size
    (quiet -> spike -> quiet), exercising both autoscale directions.
    """
    fleet = ServingFleet(run_dir, config, device=device)
    c = fleet.config
    fleet.build_source_image()
    fleet.boot_fleet()
    if trace is None:
        k = max(1, len(fleet.serving()))
        trace = [1, 1, 3 * k, 3 * k, 1, 0, 0, 0]
    fleet.serve_trace(trace)
    summary = fleet.summary()
    summary["fleet"] = True
    return summary

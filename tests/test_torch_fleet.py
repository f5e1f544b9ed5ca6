"""Snapshot-fork serving fleet in the port: K replicas from one committed
image.

Ports every case of tests/test_fleet.py to ``repro_torch`` at smoke size
with ``device="cpu"``: every replica booted from the image decodes
token-identical to the solo server (eager and lazy restore), CAS dedup
makes fan-out bytes sub-linear in K, a mid-boot ``host_kill`` quarantines
the dead replica without taking the fleet down (the JAX package's
``FaultInjector`` drives the port's chaos hooks: the hook protocol is
shared), and the autoscaler boots on a spike and drains on idle — all
deterministic, no wall-clock assertions.  Then what the port adds: a
drained replica frees its tensors, and ``run_fleet`` end to end.
"""
import contextlib
import weakref

import numpy as np
import pytest
import torch

from repro.chaos.injector import FaultInjector
from repro.chaos.plan import ChaosConfig, FaultEvent
from repro_torch.chaos import hooks as port_hooks
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.orchestrator.fleet import (FleetConfig, ServingFleet,
                                            run_fleet)
from repro_torch.orchestrator.workloads import host_cas_dir
from repro_torch.transfer import ChunkStore


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mini(**kw):
    base = dict(replicas=2, hosts=1, warm_tokens=2, max_seq=48)
    base.update(kw)
    return FleetConfig(**base)


@contextlib.contextmanager
def _installed(injector):
    port_hooks.install(injector)
    try:
        yield injector
    finally:
        port_hooks.uninstall()


@pytest.mark.parametrize("mode", ["eager", "lazy"])
def test_replicas_bit_exact_vs_solo(mode, run_dir):
    """Every forked replica continues the generation token-identical to
    the solo server that never went through a restore."""
    fleet = ServingFleet(run_dir, _mini(restore_mode=mode), device="cpu")
    fleet.build_source_image()
    # the unforked continuation: 5 more tokens past the image point
    solo = fleet.source.decode(5).copy()
    fleet.boot_fleet()
    assert len(fleet.serving()) == 2
    for rep in fleet.replicas:
        assert rep.status == "serving"
        assert rep.ttft_s is not None and rep.ttft_s > 0
        got = rep.server.decode(4)          # boot already decoded 1
        np.testing.assert_array_equal(solo, got)
        # the boot is one fully-phased recovery incident (TTFT window)
        (b,) = rep.recovery.breakdown()
        assert b["cause"] == "fleet_boot"
        assert b["total_s"] is not None
        assert b["transfer_s"] is not None
        assert b["restore_s"] is not None


def test_cold_boot_needs_no_prestarted_skeleton(run_dir):
    """A fresh DecodeServer restores straight from the image — no prefill
    re-execution, no hand-crafted cache skeleton."""
    fleet = ServingFleet(run_dir, _mini(replicas=1), device="cpu")
    fleet.build_source_image()
    rep = fleet.boot_replica()
    srv = rep.server
    assert srv.pos == fleet.image_step + 1      # image point + first token
    assert srv.params is not None and srv.cache is not None


def test_host_kill_mid_boot_quarantines_replica(run_dir):
    """A host dying mid-boot kills that replica's boot; the fleet keeps
    serving and the dead replica is diagnosably quarantined."""
    cfg = ChaosConfig(
        seed=0, hosts=1, counts={"host_kill": 1},
        events=[FaultEvent(kind="host_kill", job_id="r001",
                           at_step=0, seq=0)])
    inj = FaultInjector(cfg)
    fleet = ServingFleet(run_dir, _mini(replicas=3), device="cpu")
    fleet.build_source_image()
    with _installed(inj):
        fleet.boot_fleet()
    dead = fleet.quarantined()
    assert [r.rid for r in dead] == ["r001"]
    assert "chaos" in dead[0].diagnosis
    assert dead[0].server is None
    assert inj.injected_counts() == {"host_kill": 1}
    # the surviving replicas serve the whole trace
    live = fleet.serving()
    assert len(live) == 2
    stats = fleet.serve_trace([2, 2, 0, 0, 0])
    assert stats["requests_unserved"] == 0
    solo = fleet.source.decode(1).copy()
    got = live[0].server.tokens
    np.testing.assert_array_equal(solo, got[:, : solo.shape[1]])


def test_cas_dedup_makes_fanout_sublinear(run_dir):
    """K replicas on one host: the first boot fills the host CAS, every
    later boot negotiates have/want and ships zero new chunk bytes —
    total restore bytes stay under 2x one restore for any K."""
    K = 6
    fleet = ServingFleet(run_dir, _mini(replicas=K), device="cpu")
    fleet.build_source_image()
    fleet.boot_fleet()
    sent = [r.transfer["bytes_sent"] for r in fleet.replicas]
    assert sent[0] > 0                       # cold fill pays once
    assert all(s == 0 for s in sent[1:])     # warm boots ship nothing
    assert sum(sent) < 2 * sent[0]           # sub-linear in K
    # the host CAS's own transfer log agrees with our accounting
    log = ChunkStore(host_cas_dir(run_dir, "h0")).transfer_log()
    assert len(log) == K
    assert sum(t["bytes_sent"] for t in log) == sum(sent)
    assert all(t["chunks_reused"] > 0 for t in log[1:])
    s = fleet.summary()
    assert s["restore_bytes_vs_image"] < 2.0
    assert s["hosts"]["h0"]["cas_log_bytes_sent"] == sum(sent)


def test_serve_trace_autoscales_up_and_drains(run_dir):
    """Queue spike boots a replica through the measured path; sustained
    idle drains back down — both visible in the summary."""
    fleet = ServingFleet(
        run_dir, _mini(replicas=2, scale_up_depth=2, drain_idle_ticks=1,
                       min_replicas=1, max_replicas=8), device="cpu")
    fleet.build_source_image()
    fleet.boot_fleet()
    stats = fleet.serve_trace([1, 12, 0, 0, 0, 0])
    assert stats["requests_unserved"] == 0
    assert stats["requests_served"] == 13
    assert stats["autoscale_boots"] >= 1
    assert stats["drains"] >= 1
    assert stats["goodput_requests_per_replica_tick"] > 0
    booted = [r for r in fleet.replicas if r.autoscaled]
    assert booted and all(r.ttft_s is not None for r in booted)
    # deterministic: the same trace replays to the same counts
    fleet2 = ServingFleet(
        str(run_dir) + "_b",
        _mini(replicas=2, scale_up_depth=2, drain_idle_ticks=1,
              min_replicas=1, max_replicas=8), device="cpu")
    fleet2.build_source_image()
    fleet2.boot_fleet()
    stats2 = fleet2.serve_trace([1, 12, 0, 0, 0, 0])
    for k in ("requests_served", "autoscale_boots", "drains", "ticks",
              "replica_ticks"):
        assert stats[k] == stats2[k]


# ------------------------------------------------------ the port's own
def test_drained_replica_frees_its_tensors(run_dir):
    """Draining a replica drops its params and KV cache at once."""
    fleet = ServingFleet(run_dir, _mini(replicas=2, drain_idle_ticks=1,
                                        min_replicas=1), device="cpu")
    fleet.build_source_image()
    fleet.boot_fleet()
    last = fleet.replicas[-1]
    refs = [weakref.ref(t) for t in flatten_with_paths(
        {"p": last.server.params, "c": last.server.cache}).values()]
    stats = fleet.serve_trace([1, 0, 0])
    assert stats["drains"] == 1 and last.status == "drained"
    assert refs and all(r() is None for r in refs)


def test_run_fleet_end_to_end(run_dir):
    """One call: image, K replicas over 2 hosts, the default burst; the
    second replica of a host ships nothing new."""
    s = run_fleet(run_dir, _mini(replicas=4, hosts=2), device="cpu")
    assert s["fleet"] and s["requests_unserved"] == 0
    assert s["autoscale_boots"] >= 1 and s["drains"] >= 1
    per = {r["rid"]: r for r in s["per_replica"]}
    assert per["r000"]["bytes_sent"] > 0 and per["r001"]["bytes_sent"] > 0
    assert per["r002"]["bytes_sent"] == 0 and per["r003"]["bytes_sent"] == 0
    assert s["hosts"]["h0"]["replicas"] >= 2

"""The port's observability plane (``repro_torch.obs``): the run journal,
its exporters and the plane that wires them, against the JAX package.

Ports tests/test_obs.py:320-457 (journal validation and filters, the
Chrome export, the flat metrics, a torn tail, job attribution, recovery
phases as spans, chaos injections in the journal, the CLI's ``trace`` /
``events`` / ``metrics``) to ``repro_torch``; then each package's
``validate_journal`` accepts the other's journal, and both packages'
``to_chrome_trace`` and ``metrics_from_journal`` give equal output on the
same journal; last, every span name the port emits is in its schema.
"""
import json
import re
import subprocess
import time
from pathlib import Path

import pytest

from repro.obs import export as jax_export
from repro.obs import journal as jax_journal
from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro.obs.plane import observed as jax_observed
from repro_torch.obs import export, journal, metrics, trace
from repro_torch.obs.plane import ObservabilityPlane, observed

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _tiny_run(run_dir, mods=None):
    """One synthetic observed run touching every event class, written by
    the port (default) or by the JAX package (``mods`` its modules)."""
    obs_, tr, met, jr, exp = mods or (observed, trace, metrics, journal,
                                      export)
    with obs_(str(run_dir)) as plane:
        with tr.context(job="j0"):
            with tr.span("dump.pause", step=1):
                time.sleep(0.001)
        t_mark = plane.tracer.clock()
        tr.record("recovery.detect", t_mark, t_mark + 0.01,
                  job="j0", cause="preemption")
        met.counter_add("dump.count")
        met.observe("dump.frozen_s", 0.25)
        met.gauge_set("pack.queue_depth", 2)
        jr.emit("fault", "host_kill", job="j0", at_step=3, t=0.1)
        jr.emit("job", "transition", job="j0", frm="running",
                to="freezing", step=1)
        jr.emit("job", "transition", job="other", frm="pending",
                to="running", step=0)
    return exp.load_journal(str(run_dir))


JAX_MODS = (jax_observed, jax_trace, jax_metrics, jax_journal, jax_export)


def test_journal_validates_and_filters(tmp_path):
    events = _tiny_run(tmp_path / "run")
    assert export.validate_journal(events) == []
    assert events[0]["kind"] == "journal_open"
    faults = export.filter_events(events, cls="fault")
    assert [e["kind"] for e in faults] == ["host_kill"]
    j0 = export.filter_events(events, job="j0")
    kinds = {(e.get("cls"), e.get("kind")) for e in j0}
    assert ("dump", "span") in kinds
    assert ("recovery", "span") in kinds
    assert ("fault", "host_kill") in kinds
    assert all(export._event_job(e) == "j0" for e in j0)
    ts = [export._event_t(e) for e in j0]
    assert ts == sorted(ts)


def test_chrome_trace_export(tmp_path):
    events = _tiny_run(tmp_path / "run")
    parsed = json.loads(json.dumps(export.to_chrome_trace(events)))
    evs = parsed["traceEvents"]
    complete = [e for e in evs if e["ph"] == "X"]
    instants = [e for e in evs if e["ph"] == "i"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert {e["name"] for e in complete} >= {"dump.pause",
                                             "recovery.detect"}
    assert any(e["name"] == "fault:host_kill" for e in instants)
    assert any("->" in e["name"] for e in instants)
    assert any(e["name"] == "process_name" for e in meta)
    for e in complete:
        assert e["ts"] >= 0 and e["dur"] >= 0 and e["tid"] >= 1


def test_metrics_snapshot_flattens(tmp_path):
    flat = export.metrics_from_journal(_tiny_run(tmp_path / "run"))
    assert flat["obs.counter.dump.count"] == 1
    assert flat["obs.gauge.pack.queue_depth"] == 2
    assert flat["obs.hist.dump.frozen_s.count"] == 1
    assert flat["obs.hist.dump.frozen_s.sum"] == pytest.approx(0.25)


def test_journal_tolerates_torn_tail(tmp_path):
    run = tmp_path / "run"
    _tiny_run(run)
    with open(journal.journal_path(str(run)), "a") as f:
        f.write('{"v": 1, "cls": "dump", "ki')   # crash mid-line
    events = export.load_journal(str(run))
    assert export.validate_journal(events) == []
    assert journal.journal_path(str(run)) == \
        jax_journal.journal_path(str(run))


def test_journal_inherits_job_from_trace_context(tmp_path):
    with observed(str(tmp_path / "run")):
        with trace.context(job="jx"):
            journal.emit("dump", "commit", step=5)
        journal.emit("dump", "commit", step=6)
    events = export.load_journal(str(tmp_path / "run"))
    commits = {e["step"]: e.get("job")
               for e in events if e.get("kind") == "commit"}
    assert commits == {5: "jx", 6: None}


def test_install_is_exclusive(tmp_path):
    plane = ObservabilityPlane(str(tmp_path / "run"))
    plane.install()
    try:
        other = ObservabilityPlane(str(tmp_path / "run2"))
        with pytest.raises(RuntimeError, match="already installed"):
            other.install()
        other.journal.close()
    finally:
        plane.close()
    assert trace.TRACER is None and journal.JOURNAL is None
    assert metrics.REGISTRY is None


def test_recovery_phases_become_spans(tmp_path):
    from repro_torch.orchestrator.recovery import RecoveryLog
    with observed(str(tmp_path / "run")) as plane:
        clk = plane.tracer.clock
        log = RecoveryLog(job_id="j9")
        t = clk()
        log.open("failure", t_interrupt=t, t_detect=t + 0.01,
                 step_at_interrupt=7, last_ckpt_step=6)
        log.mark_transfer(t + 0.01, t + 0.02, bytes_sent=10)
        log.mark_scheduled(t + 0.03)
        log.mark_restored(t + 0.05, restored_step=6)
        log.mark_materialized(t + 0.06)
        log.mark_caught_up(t + 0.08)
        names = [sp.name for sp in plane.tracer.spans]
        assert names == ["recovery.detect", "recovery.transfer",
                         "recovery.schedule", "recovery.restore",
                         "recovery.restore_background",
                         "recovery.replay"]
        assert all(sp.attrs["job"] == "j9" for sp in plane.tracer.spans)
        assert all(sp.t_end >= sp.t_start for sp in plane.tracer.spans)
    events = export.load_journal(str(tmp_path / "run"))
    kinds = [e["kind"] for e in events if e["cls"] == "recovery"]
    assert "incident_open" in kinds and "incident_closed" in kinds
    assert log.breakdown()[0]["total_s"] == pytest.approx(0.08, abs=1e-6)


def test_chaos_injections_land_in_journal(tmp_path):
    from repro_torch.chaos.injector import FaultInjector
    from repro_torch.chaos.plan import ChaosConfig, FaultEvent
    ev = FaultEvent(kind="host_kill", job_id="j1", at_step=4, seq=0)
    inj = FaultInjector(ChaosConfig(seed=0, hosts=1,
                                    counts={"host_kill": 1}, events=[ev]))
    with observed(str(tmp_path / "run")) as plane:
        inj._record(ev, step=4, host="host00")
        assert plane.registry.snapshot()["counters"][
            "chaos.injections"] == 1
    events = export.load_journal(str(tmp_path / "run"))
    faults = export.filter_events(events, cls="fault")
    assert len(faults) == 1
    assert faults[0]["kind"] == "host_kill"
    assert faults[0]["job"] == "j1"
    # the journal keeps its own clock; the injector's travels beside it
    assert faults[0]["t_injected"] == inj.injections[0]["t"]
    assert 0 <= faults[0]["t"] < 60
    # audit trail untouched in shape (campaign fingerprints unaffected)
    assert inj.injections[0]["kind"] == "host_kill"


def test_cli_trace_events_metrics(tmp_path, capsys):
    from repro_torch.cli import main
    run = tmp_path / "run"
    _tiny_run(run)

    assert main(["trace", str(run), "--chrome"]) == 0
    out = capsys.readouterr().out
    assert "trace.json" in out
    with open(run / "obs" / "trace.json") as f:
        chrome = json.load(f)
    assert any(e["ph"] == "X" for e in chrome["traceEvents"])

    assert main(["events", str(run), "--job", "j0",
                 "--class", "fault"]) == 0
    assert "host_kill" in capsys.readouterr().out

    assert main(["metrics", str(run), "--json"]) == 0
    flat = json.loads(capsys.readouterr().out)
    assert flat["obs.counter.dump.count"] == 1

    # no journal -> clean error, not a stack trace
    assert main(["events", str(tmp_path / "nowhere")]) == 1


# ------------------------------------------------------ across packages
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_journal(tmp_path, writer):
    """Same VERSION and CLASSES: each package validates a journal the
    other wrote, and both exporters give equal Chrome traces and flat
    metrics on it."""
    assert (journal.VERSION, journal.CLASSES) == \
        (jax_journal.VERSION, jax_journal.CLASSES)
    _tiny_run(tmp_path / "run", None if writer == "port" else JAX_MODS)
    ours = export.load_journal(str(tmp_path / "run"))
    theirs = jax_export.load_journal(str(tmp_path / "run"))
    assert ours == theirs and len(ours) >= 6
    assert export.validate_journal(ours) == []
    assert jax_export.validate_journal(ours) == []
    assert export.to_chrome_trace(ours, process_name="run") == \
        jax_export.to_chrome_trace(ours, process_name="run")
    assert export.metrics_from_journal(ours) == \
        jax_export.metrics_from_journal(ours)
    for cls in (None, "fault", "dump", "job"):
        for job in (None, "j0", "other"):
            assert export.filter_events(ours, job=job, cls=cls) == \
                jax_export.filter_events(ours, job=job, cls=cls)


def test_validate_journal_problems_match_the_reference():
    bad = [{"cls": "dump", "kind": "span", "t": 0.0},
           {"cls": "weird", "t": "x"}]
    assert export.validate_journal(bad) == jax_export.validate_journal(bad)
    assert export.validate_journal([]) == ["journal is empty"]


def test_schema_covers_every_emitted_span_name():
    """Every span name the port emits is a key in its SPAN_SCHEMA, and
    the schemas are the JAX package's."""
    out = subprocess.run(
        ["grep", "-rhoE", r'(span|begin|record)\(\s*"[a-z_]+\.[a-z_]+"',
         str(PORT)], capture_output=True, text=True).stdout
    names = set(re.findall(r'"([a-z_]+\.[a-z_]+)"', out))
    assert names, "span-name grep found nothing (layout changed?)"
    assert not names - set(trace.SPAN_SCHEMA)
    assert trace.SPAN_SCHEMA == jax_trace.SPAN_SCHEMA
    assert metrics.METRIC_SCHEMA == jax_metrics.METRIC_SCHEMA

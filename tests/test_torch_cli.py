"""``python -m repro_torch``: the port's CLI against real image
directories, and the options' environment round trip it rests on.

Ports tests/test_cli.py (check, inspect, verify, gc, restore --dry-run
and their failure exit codes) to images the port wrote from CPU tensors,
and the CLI cases of the other reference files: ``inspect`` of a
concurrent capture (tests/test_concurrent_capture.py:302), the restore
schedule and ``restore --dry-run --lazy`` (tests/test_lazy_restore.py),
the ``orchestrate`` smoke (tests/test_orchestrator.py:235), ``migrate``
by pre-copy and its flag checks (tests/test_precopy.py), ``jobs
--state``, ``transfer-stats --fsck --repair`` and ``chaos-campaign``'s
metrics (tests/test_chaos.py), the last held against the reference's
dict.  The subcommands that run workloads take ``--device``: ``cuda`` by
default, so the tests pass ``--device cpu``.
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api.options import CheckpointOptions as JaxOptions
from repro.api.options import TransferPolicy as JaxPolicy
from repro.cli import main as jax_main
from repro_torch.api import (CheckpointOptions, CheckpointSession,
                             OptionsError, TransferPolicy)
from repro_torch.cli import main
from repro_torch.core.snapshot_io import snapshot_dir

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def populated_run(run_dir):
    """Three incremental snapshots with device + host state."""
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(8, 8, generator=g),
             "b": torch.randn(8, generator=g)}
    s = CheckpointSession(run_dir, CheckpointOptions(incremental=True),
                          device="cpu")
    s.attach(lambda: {"train_state": state})
    s.register_host_state("cursor", lambda: {"pos": 5}, lambda v: None)
    s.checkpoint(1)
    s.checkpoint(2)
    state["w"] = state["w"] + 1.0       # make step 3 actually differ
    s.checkpoint(3)
    return run_dir


# --------------------------------------------------- tests/test_cli.py
def test_check_ok(capsys):
    assert main(["check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "repro_torch check: OK" in out
    assert "backends" in out and "torch" in out
    assert "device probe: cpu" in out


def test_check_json(capsys, tmp_path):
    assert main(["check", "--run-dir", str(tmp_path / "x"), "--json",
                 "--device", "cpu"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["ok"] is True
    assert "backends" in data["capabilities"]
    assert data["device_probe"].startswith("cpu")


def test_inspect_table(populated_run, capsys):
    assert main(["inspect", populated_run]) == 0
    out = capsys.readouterr().out
    assert "3 snapshot(s)" in out
    for col in ("step", "written", "parent chain"):
        assert col in out
    assert "2 -> 1" in out


def test_inspect_single_step(populated_run, capsys):
    assert main(["inspect", populated_run, "--step", "3"]) == 0
    out = capsys.readouterr().out
    assert "snapshot step 3" in out
    assert "parent chain: 3 -> 2 -> 1" in out
    assert "train_state" in out


def test_inspect_missing_dir(tmp_path):
    with pytest.raises(SystemExit):
        main(["inspect", str(tmp_path / "nope")])


def test_verify_ok_and_corrupt(populated_run, capsys):
    assert main(["verify", populated_run]) == 0
    assert "OK" in capsys.readouterr().out
    from repro_torch.serialization.pack import pack_files
    pack = pack_files(os.path.join(snapshot_dir(populated_run, 3),
                                   "host0000.pack"))[0]
    with open(pack, "r+b") as f:
        f.seek(40)
        f.write(b"\xde\xad\xbe\xef" * 4)
    assert main(["verify", populated_run]) == 1
    out = capsys.readouterr().out
    assert "step 3: CORRUPT" in out
    assert "step 1: OK" in out
    assert main(["verify", populated_run, "--step", "3"]) == 1
    # the JAX package's CLI agrees on the port's image
    assert jax_main(["verify", populated_run, "--step", "3"]) == 1
    assert jax_main(["verify", populated_run, "--step", "1"]) == 0


def test_restore_dry_run(populated_run, capsys):
    assert main(["restore", populated_run, "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "restore --dry-run OK" in out
    assert "train_state" in out
    assert "cursor" in out


def test_restore_without_dry_run_refuses(populated_run):
    with pytest.raises(SystemExit):
        main(["restore", populated_run])


def test_gc_keeps_referenced_parents(populated_run, capsys):
    assert main(["gc", populated_run, "--keep", "1", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "would remove 1 snapshot(s): [2]" in out
    assert main(["gc", populated_run, "--keep", "1"]) == 0
    out = capsys.readouterr().out
    assert "removed 1 snapshot(s): [2]" in out
    assert "remaining: [1, 3]" in out
    assert main(["restore", populated_run, "--dry-run", "--step", "3"]) == 0


def test_gc_removes_independent_images(run_dir, capsys):
    state = {"w": torch.ones(4, 4)}
    s = CheckpointSession(run_dir, device="cpu")     # full images
    s.attach(lambda: {"train_state": state})
    for step in (1, 2, 3):
        s.checkpoint(step)
    assert main(["gc", run_dir, "--keep", "1"]) == 0
    out = capsys.readouterr().out
    assert "removed 2 snapshot(s): [1, 2]" in out
    assert s.store.list_steps() == [3]


def test_cli_unknown_command_exits():
    with pytest.raises(SystemExit):
        main(["frobnicate"])


# --------------------------------------------- other reference files
def test_inspect_reports_capture_mode_and_stats(tmp_path, capsys):
    state = {f"w{i}": torch.full((4096,), float(i)) for i in range(3)}
    run = str(tmp_path / "c")
    c = CheckpointSession(run, CheckpointOptions(
        incremental=True, capture="concurrent"), device="cpu")
    c.attach(lambda: {"state": state})
    handle = c.checkpoint_begin(1)
    assert handle.wait_speculated(60.0)
    state["w0"][:] = 5.0
    handle._tracker.note("state::w0")
    c.checkpoint_finalize()
    assert main(["inspect", run, "--step", "1"]) == 0
    out = capsys.readouterr().out
    assert "capture:     concurrent" in out
    assert "frozen window:" in out
    assert "re-captured:" in out


def _train_shape_run(run_dir):
    g = torch.Generator().manual_seed(0)

    def block():
        return torch.randint(0, 9, (8 * 256,), generator=g).float()

    keys = [f"w{i}" for i in range(4)]
    state = {"params": {k: block() for k in keys},
             "opt": {"m": {k: block() for k in keys},
                     "v": {k: block() for k in keys}}}
    s = CheckpointSession(run_dir, CheckpointOptions(), device="cpu")
    s.attach(lambda: {"train_state": state})
    s.register_host_state("cursor", lambda: {"step": 1}, lambda st: None)
    s.checkpoint(1)


def test_cli_inspect_shows_restore_schedule(run_dir, capsys):
    _train_shape_run(run_dir)
    assert main(["inspect", run_dir, "--step", "1"]) == 0
    out = capsys.readouterr().out
    assert "restore schedule" in out
    assert "train_state/params" in out and "train_state/opt" in out
    assert "(host blobs)" in out


def test_cli_restore_dry_run_lazy(run_dir, capsys):
    _train_shape_run(run_dir)
    assert main(["restore", run_dir, "--dry-run", "--lazy",
                 "--critical", "train_state/params"]) == 0
    out = capsys.readouterr().out
    assert "resumed on the critical set" in out
    assert "resume-before-read" in out


def test_orchestrate_cli_smoke(tmp_path, capsys):
    out = str(tmp_path / "cli_run")
    assert main(["orchestrate", out, "--scenario", "failure",
                 "--kind", "intercept", "--steps", "6",
                 "--device", "cpu"]) == 0
    assert "run journal ->" in capsys.readouterr().out
    assert main(["jobs", out]) == 0
    capsys.readouterr()
    assert main(["jobs", out, "--json"]) == 0
    (row,) = json.loads(capsys.readouterr().out)
    assert isinstance(row["step"], int) and isinstance(
        row["recovery_s"], float)
    # the journal the plane wrote reads back
    assert main(["events", out, "--class", "job"]) == 0
    assert "job/transition" in capsys.readouterr().out


# ----------------------------------------------------------- options
def test_options_env_round_trip_matches_reference():
    kw = dict(restore_mode="lazy", critical_states=("a", "b/c/d"),
              replicate_to="/peer", keep=3, capture="sync", stripes=4)
    o = CheckpointOptions(**kw, transfer_policy=TransferPolicy(
        mode="delta", precopy_rounds=3, max_blackout_ms=100.0))
    assert CheckpointOptions.from_env(o.to_env()) == o
    ref = JaxOptions(**kw, transfer_policy=JaxPolicy(
        mode="delta", precopy_rounds=3, max_blackout_ms=100.0))
    assert o.to_env() == ref.to_env()
    assert CheckpointOptions().to_env() == JaxOptions().to_env()
    assert CheckpointOptions(critical_states=["x"]).critical_states == ("x",)
    assert o.effective_io_threads() >= 2
    with pytest.raises(OptionsError):
        CheckpointOptions(restore_mode="sometimes")


def test_session_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CKPT_MODE", "async")
    monkeypatch.setenv("REPRO_CKPT_INCREMENTAL", "1")
    s = CheckpointSession.from_env(str(tmp_path / "r"), device="cpu")
    assert s.options.mode == "async" and s.options.incremental


def test_options_carry_policy_through_env():
    p = TransferPolicy(mode="delta", precopy_rounds=3, max_blackout_ms=100.0)
    env = CheckpointOptions(transfer_policy=p).to_env()
    assert "REPRO_CKPT_TRANSFER_POLICY" in env
    assert "REPRO_CKPT_TRANSFER" not in env
    back = CheckpointOptions.from_env(env)
    assert back.transfer_policy == p
    assert back.transfer == "delta"


def test_legacy_transfer_kwargs_warn_and_map():
    import repro_torch.api.options as mod
    mod._WARNED.discard("options.transfer-kwargs")
    with pytest.warns(DeprecationWarning, match="transfer"):
        opts = CheckpointOptions(transfer="delta", transfer_workers=2)
    assert opts.transfer_policy == TransferPolicy(mode="delta", workers=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        CheckpointOptions(transfer="delta", transfer_workers=2)
    with pytest.raises(OptionsError):
        CheckpointOptions(transfer="copy",
                          transfer_policy=TransferPolicy(mode="delta"))
    # legacy env vars map too (with their own one-time warning)
    mod._WARNED.discard("options.transfer-env")
    with pytest.warns(DeprecationWarning, match="TRANSFER_POLICY"):
        o = CheckpointOptions.from_env({"REPRO_CKPT_TRANSFER": "delta",
                                        "REPRO_CKPT_TRANSFER_WORKERS": "3"})
    assert o.transfer_policy == TransferPolicy(mode="delta", workers=3)


# ----------------------------------------------------------- transfer
def _chain(run_dir, steps=5, entries=6, entry_kb=64, seed=0):
    rng = np.random.default_rng(seed)

    def block():
        return torch.from_numpy(rng.integers(0, 8, size=entry_kb * 256)
                                .astype(np.float32))

    state = {f"t{i}": block() for i in range(entries)}
    s = CheckpointSession(run_dir, CheckpointOptions(incremental=True),
                          device="cpu")
    s.attach(lambda: {"train_state": state})
    names = sorted(state)
    for step in range(1, steps + 1):
        if step > 1:
            for i in range(2):
                state[names[(step * 2 + i) % entries]] = block()
        s.checkpoint(step)
    return state


def _restored(peer):
    r = CheckpointSession(peer, CheckpointOptions(), device="cpu")
    r.attach(lambda: {"train_state": None})
    return r.restore()["train_state"]


def test_migrate_cli_precopy_mode(tmp_path, capsys):
    state = _chain(str(tmp_path / "src"))
    peer = str(tmp_path / "peer")
    assert main(["migrate", str(tmp_path / "src"), peer,
                 "--max-rounds", "8", "--max-blackout-ms", "60000",
                 "--json"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["outcome"] in ("converged", "fallback")
    assert stats["rounds_completed"] >= 1
    assert stats["residual_bytes"] > 0
    assert stats["rounds"][-1]["residual"]
    got = _restored(peer)
    assert sorted(got) == sorted(state)
    for k in state:
        assert torch.equal(got[k], state[k]), k
    assert main(["migrate", str(tmp_path / "src"),
                 str(tmp_path / "peer2"), "--max-rounds", "8"]) == 0
    out = capsys.readouterr().out
    assert "blackout" in out and "CRC-clean" in out
    # a plain delta migrate is idempotent: the second ships nothing
    assert main(["migrate", str(tmp_path / "src"), peer, "--json"]) == 0
    again = json.loads(capsys.readouterr().out)
    assert again["bytes_sent"] == 0 and again["steps_transferred"] == 0


def test_migrate_cli_precopy_flag_validation(tmp_path):
    _chain(str(tmp_path / "src"), steps=1)
    with pytest.raises(SystemExit, match="--transfer delta"):
        main(["migrate", str(tmp_path / "src"), str(tmp_path / "p"),
              "--transfer", "copy", "--max-rounds", "4"])
    with pytest.raises(SystemExit, match="--max-rounds"):
        main(["migrate", str(tmp_path / "src"), str(tmp_path / "p"),
              "--max-blackout-ms", "100"])


def test_transfer_stats_repair_cli(tmp_path, capsys):
    from repro_torch.transfer import DeltaReplicator
    _chain(str(tmp_path / "src"), steps=1, entries=4, entry_kb=8)
    peer = str(tmp_path / "peer")
    DeltaReplicator(peer, workers=1).push(str(tmp_path / "src"), 1)
    objs = []
    for dirpath, _d, files in os.walk(os.path.join(peer, ".cas",
                                                   "objects")):
        objs += [os.path.join(dirpath, f) for f in files]
    open(sorted(objs)[0], "ab").write(b"x")
    assert main(["transfer-stats", peer, "--fsck"]) == 1
    capsys.readouterr()
    assert main(["transfer-stats", peer, "--repair", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["cas"]["corrupt_objects"] == 1
    assert payload["cas"]["quarantined_objects"] == 1
    assert main(["transfer-stats", peer, "--fsck"]) == 0


# -------------------------------------------------------------- chaos
def test_campaign_cli_emits_metrics_and_jobs_filter(tmp_path, capsys):
    """tests/test_chaos.py's campaign CLI and ``jobs --state`` cases."""
    fleet = str(tmp_path / "fleet")
    bench = str(tmp_path / "chaos.json")
    rc = main(["chaos-campaign", fleet, "--jobs", "4", "--hosts", "2",
               "--seed", "5", "--faults", "torn_write=1,exhaust=1",
               "--json", bench, "--report", str(tmp_path / "r.json"),
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "invariant held" in out and "fingerprint:" in out
    m = json.load(open(bench))
    assert m["chaos.invariant.violation_ratio"] == 0.0
    assert m["chaos.torn_write.missed_injection_ratio"] == 0.0
    assert m["chaos.torn_write.unsurvived_ratio"] == 0.0
    assert m["chaos.exhaust.quarantined_ratio"] == 1.0
    report = json.load(open(tmp_path / "r.json"))
    quarantined = {j for j, o in report["outcomes"].items()
                   if o == "quarantined"}
    assert main(["jobs", fleet, "--state", "failed", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert {r["job"] for r in rows} == quarantined
    assert all(r["exhausted"] and "host" in r for r in rows)
    assert main(["jobs", fleet, "--state", "done", "--json"]) == 0
    done = {r["job"] for r in json.loads(capsys.readouterr().out)}
    assert done == {j for j, o in report["outcomes"].items()
                    if o == "recovered"}
    with pytest.raises(SystemExit, match="unknown state"):
        main(["jobs", fleet, "--state", "zombie"])
    # the campaign's journal: one fault row per injection
    assert main(["events", fleet, "--class", "fault", "--json"]) == 0
    faults = [json.loads(line) for line in
              capsys.readouterr().out.splitlines()]
    assert sorted(f["kind"] for f in faults) == ["exhaust", "torn_write"]


@pytest.mark.parametrize("capture", ["sync", "sweep"])
def test_campaign_cli_json_matches_reference(tmp_path, capsys, capture):
    """``chaos-campaign --json`` writes the reference's metrics dict,
    but for its times (``*wall_s``, ``*mttr_s``)."""
    argv = ["--jobs", "4", "--hosts", "2", "--seed", "5", "--faults",
            "torn_write=1,exhaust=1,signal_dup=1", "--capture", capture]
    assert main(["chaos-campaign", str(tmp_path / "port"), *argv,
                 "--json", str(tmp_path / "port.json"),
                 "--device", "cpu", "--no-trace"]) == 0
    assert jax_main(["chaos-campaign", str(tmp_path / "jax"), *argv,
                     "--json", str(tmp_path / "jax.json"),
                     "--no-trace"]) == 0
    out = capsys.readouterr().out
    fps = [line for line in out.splitlines()
           if line.startswith("fingerprint:")]
    assert len(fps) == 2 and fps[0] == fps[1]

    def untimed(path):
        m = json.load(open(path))
        return {k: v for k, v in m.items()
                if not k.endswith(("wall_s", "mttr_s"))}
    ours, ref = untimed(tmp_path / "port.json"), untimed(tmp_path / "jax.json")
    assert ours == ref and len(ours) > 10


def test_module_help_never_imports_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['python -m repro_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('repro_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print('IMPORTED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "chaos-campaign" in out.stdout and "serve-fleet" in out.stdout
    assert out.stdout.strip().endswith("IMPORTED []")
    run = subprocess.run([sys.executable, "-m", "repro_torch", "--help"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0 and "python -m repro_torch" in run.stdout

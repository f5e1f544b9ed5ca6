"""The engine's modes across processes: two gloo ranks on the CPU.

Incremental images, lazy restore, concurrent capture and replication,
each over ``make_host_mesh(data=2, model=1)`` with one pack per rank
under the two-phase commit, held against the JAX package on a 2-device
mesh (its Trainer, its launcher and its SnapshotEngine, in subprocesses
with 2 host devices).  Smoke qwen1.5, global batch 4 x 16, 6 steps from
JAX's step-0 image; losses within rtol 1e-4 of JAX's, images restored
bit-exact by JAX.

  (a) incremental: ``--incremental`` through the launcher (JAX's losses
      and parents; JAX restores the step-6 image onto 2 devices and 1);
      the entries an engine dump reuses from its parent, over both ranks,
      are JAX's; ``keep=1`` keeps every rank's pack of a parent still
      read, and a restart is bitwise; rank 1's store seeing another
      newest step does not change the parent;
  (b) lazy restore: before the call returns each rank has read only the
      critical entries (params) of its own blocks; the losses equal an
      eager restore's bitwise; a torn chunk of rank 1's optimizer state
      (no replica) quarantines the step on both ranks, and both fall back
      to the previous image within the group's timeout;
  (c) concurrent capture: every image's entries CRC for CRC those of the
      sync image at the step of its validate pause; with rank 1's
      speculation held back, both ranks still validate at the same step;
  (d) replication, copy and delta: the replica holds both ranks' packs,
      ``transfers.json`` one record per rank's push; with the primary
      deleted a 2-rank restore from the replica is bitwise; a rank killed
      between its pack's push and its marker leaves the replica without
      that step's manifest.

The ranks run targets of this file's own (``_TARGETS``, written beside
the runs) under ``launch.dist.launch``; every subprocess has one torch
thread per rank and is bounded by a timeout.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from repro_torch.core.device_plugin import assemble_global
from repro_torch.core.snapshot_io import MANIFEST, SnapshotStore, snapshot_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
STEPS = 6
TIMEOUT_S = 150          # per subprocess; the ranks' own deadlines are
BARRIER_S = 8            # far below it (the group's timeout)
BASE = ["--smoke", "--device", "cpu", "--batch-size", "4", "--seq-len",
        "16", "--ckpt-mode", "sync", "--dist-timeout", str(BARRIER_S)]


def _env(extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + (extra or [])))
    env.pop("XLA_FLAGS", None)
    return env


def _ok(res):
    rc, out, err, _ = res
    assert rc == 0, (out[-2000:], err[-3000:])
    return out


def _json(out):
    return json.loads(out[out.index("{\n"):])


_TARGETS = textwrap.dedent('''
    """Rank targets: the engine's modes over 2 ranks."""
    import json
    import os
    import shutil
    import threading
    import time
    import zlib

    import numpy as np
    import torch

    from repro_torch.api import CheckpointOptions
    from repro_torch.api.options import TransferPolicy
    from repro_torch.chaos import hooks
    from repro_torch.core.engine import ConcurrentCapture
    from repro_torch.core.snapshot_io import (SnapshotReader,
                                              SnapshotStore, snapshot_dir)
    from repro_torch.launch import dist, train


    def _opts(**kw):
        return CheckpointOptions(mode="sync", keep=0, **kw)


    def _trainer(group, run, ckpt, every=2):
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.runtime.trainer import TrainConfig, Trainer
        from repro_torch.sharding import get_policy
        mesh = make_host_mesh(data=group.world, model=1,
                              device=group.device, group=group)
        tcfg = TrainConfig(batch_size=4, seq_len=16, lr=3e-4,
                           total_steps=6, ckpt_every=every, ckpt=ckpt,
                           seed=0, compute_dtype=torch.float32)
        return Trainer(get_smoke_config("qwen1.5-0.5b"), tcfg, run,
                       mesh=mesh, policy=get_policy("baseline"))


    def _sync(group):
        group.all_ranks(True)


    def _copy_steps(group, src, dst, upto):
        """Rank 0 copies `src`'s images up to step `upto` into `dst`."""
        if group.rank == 0:
            for s in SnapshotStore(src).list_steps():
                if s <= upto:
                    shutil.copytree(snapshot_dir(src, s),
                                    snapshot_dir(dst, s))
        _sync(group)


    def _report(group, path, obj):
        got = group.gather_objects(obj)
        if group.rank == 0:
            with open(path, "w") as f:
                json.dump(got, f)
        return 0


    def _blocks(trainer):
        """crc32 of this rank's block of every leaf of the state."""
        from repro_torch.core.device_plugin import flatten_with_paths
        flat = flatten_with_paths({"params": trainer.params,
                                   "opt": trainer.opt_state})
        return {k: zlib.crc32(t.detach().contiguous().numpy().tobytes())
                for k, t in flat.items()}


    class _Reads:
        """Pack entries this process reads or verifies, by thread."""

        def __init__(self):
            self.names = []
            self.saved = {}
            for m in ("_read", "_read_array", "_verify_one"):
                fn = getattr(SnapshotReader, m)
                self.saved[m] = fn

                def rec(reader, name, _fn=fn):
                    self.names.append(
                        (threading.current_thread().name, name))
                    return _fn(reader, name)
                setattr(SnapshotReader, m, rec)

        def undo(self):
            for m, fn in self.saved.items():
                setattr(SnapshotReader, m, fn)


    def lazy(argv, group):
        """(b): eager and lazy restores of base's step 4 run to 6; a
        lazy restore of a step 4 whose chunk of rank 1's optimizer state
        is torn."""
        root, base = argv
        out = {}
        for kind in ("eager", "lazy", "torn"):
            run = os.path.join(root, kind)
            _copy_steps(group, base, run, 4)
            if kind == "torn" and group.rank == 0:
                from repro_torch.serialization.pack import (open_pack,
                                                            stripe_path)
                packs = os.path.join(snapshot_dir(run, 4), "host0001.pack")
                r = open_pack(packs, verify=False)
                name = sorted(n for n in r.index
                              if n.startswith("train_state::opt/m/"))[0]
                c = r.index[name]["chunks"][0]
                r.close()
                with open(stripe_path(packs, c["stripe"]), "r+b") as f:
                    f.seek(c["offset"] + 8)
                    f.write(b"\\xde\\xad\\xbe\\xef")
                out["torn_entry"] = name
            _sync(group)
            t = _trainer(group, run, _opts(
                restore_mode="eager" if kind == "eager" else "lazy"), 0)
            reads = _Reads() if kind == "lazy" else None
            t0 = time.monotonic()
            at = t.restore()
            if reads is not None:
                reads.undo()
                out["critical_reads"] = sorted(
                    {n for th, n in reads.names
                     if th != "repro-lazy-materializer"})
            rec = {"restored_at": at}
            try:
                t.run_until(6)
            except Exception as e:                 # noqa: BLE001
                rec["error"] = type(e).__name__
                rec["quarantined"] = sorted(t.engine._quarantined)
                rec["retry_at"] = t.restore()
                t.run_until(6)
            rec["wall_s"] = time.monotonic() - t0
            rec["losses"] = t.metrics_history["loss"]
            rec["blocks"] = _blocks(t)
            out[kind] = rec
        return _report(group, os.path.join(root, "lazy.json"), out)


    class _Hold:
        """Rank 1's speculation stalls at its first leaf of each image."""

        def __init__(self, stall_s):
            self.stall_s = stall_s
            self.seen = set()

        def on(self, site, **ctx):
            if site == "engine.speculate" and ctx["step"] not in self.seen:
                self.seen.add(ctx["step"])
                time.sleep(self.stall_s)


    def concurrent(argv, group):
        """(c): soft-freeze captures every 2 steps from JAX's step 0;
        then again with rank 1's speculation held back."""
        root, start = argv
        out = {}
        for kind in ("free", "held"):
            run = os.path.join(root, "conc_" + kind)
            _copy_steps(group, start, run, 0)
            t = _trainer(group, run, _opts(capture="concurrent",
                                           incremental=True))
            hold = _Hold(0.2)
            if kind == "held" and group.rank == 1:
                hooks.install(hold)
            finalized = []
            fin = ConcurrentCapture.finalize

            def finalize(h, t=t, fin=fin, finalized=finalized):
                # (the image's step, the trainer's step at its validate)
                finalized.append([h.step, t.step])
                return fin(h)
            ConcurrentCapture.finalize = finalize
            t.restore()
            t.run_until(6)
            ConcurrentCapture.finalize = fin
            hooks.uninstall()
            out[kind] = {"losses": t.metrics_history["loss"],
                         "finalized": finalized,
                         "held": sorted(hold.seen)}
        return _report(group, os.path.join(root, "concurrent.json"), out)


    def replicate(argv, group):
        """(d): images every 2 steps from JAX's step 0 replicated in copy
        and in delta mode; then, with the primary deleted, a restore."""
        root, start = argv
        out = {}
        for mode in ("copy", "delta"):
            run = os.path.join(root, "rep_" + mode)
            peer = os.path.join(root, "peer_" + mode)
            opts = _opts(incremental=True, replicate_to=peer,
                         transfer_policy=TransferPolicy(mode=mode))
            _copy_steps(group, start, run, 0)
            t = _trainer(group, run, opts)
            t.restore()
            pushes = []
            ckpt = t.session.checkpoint

            def checkpoint(step, t=t, ckpt=ckpt, pushes=pushes):
                path = ckpt(step)
                st = t.session.last_stats
                pushes.append({k: v for k, v in st.items()
                               if k.startswith("replica")
                               or k == "replicate_s"})
                return path
            t.session.checkpoint = checkpoint
            t.run_until(6)
            rec = {"losses": t.metrics_history["loss"], "pushes": pushes,
                   "blocks": _blocks(t)}
            t.release()
            _sync(group)
            if group.rank == 0:
                shutil.copytree(run, run + "_primary")
                shutil.rmtree(run)
            _sync(group)
            back = _trainer(group, run, opts)
            rec["restored_at"] = back.restore()
            rec["from_replica"] = back.engine.last_restore_stats.get(
                "restored_from_replica")
            rec["restored_blocks"] = _blocks(back)
            out[mode] = rec
        return _report(group, os.path.join(root, "replicate.json"), out)


    def kill_replica(argv, group):
        """(d): rank 1 is SIGKILLed between its push of step 4's pack and
        its marker at the replica."""
        root, start = argv
        run = os.path.join(root, "rep_kill")
        _copy_steps(group, start, run, 0)
        if group.rank == 1:
            hooks.install(dist.KillBeforePrepare(4, "replica.prepare"))
        t = _trainer(group, run, _opts(
            incremental=True, replicate_to=os.path.join(root, "peer_kill")))
        t.restore()
        t.run_until(6)
        return 0


    def engine(argv, group):
        """(a): an engine over the process mesh dumps a state of changed
        and unchanged leaves twice (keep=1), then once with rank 1's store
        hiding the newest image."""
        from repro_torch.core import SnapshotEngine
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.sharding import NamedSharding, PartitionSpec
        from repro_torch.sharding.policy import local_block
        root, = argv
        run = os.path.join(root, "engine")
        mesh = make_host_mesh(data=group.world, model=1,
                              device=group.device, group=group)
        specs = {"a": (8, 6), "b": (5,), "c": (8, 4), "d": (3, 8)}
        parts = {"a": ("data",), "b": (), "c": ("data",),
                 "d": (None, "data")}
        sh = {k: NamedSharding(mesh, PartitionSpec(*parts[k]))
              for k in specs}
        whole = {k: torch.arange(int(np.prod(s)), dtype=torch.float32
                                 ).reshape(s) / 7.0
                 for k, s in specs.items()}
        live = {"s": {k: local_block(whole[k], sh[k]) for k in specs}}
        eng = SnapshotEngine(run, options=CheckpointOptions(
            incremental=True, keep=1), device="cpu", mesh=mesh)
        eng.attach(lambda: live, {"s": sh})
        eng.checkpoint(1)
        for k in ("a", "b"):
            live["s"][k] = live["s"][k] + 1.0
        eng.checkpoint(2)
        out = {"parents": [], "reused": None}
        man = SnapshotStore(run).manifest(2)
        out["reused"] = sorted(n for n, loc in man["locations"].items()
                               if loc.startswith("step_00000001/"))
        if group.rank == 1:
            eng.store.list_steps = lambda: [1]     # hides step 2
        eng.checkpoint(3)
        out["parent_step"] = eng.last_stats.get("parent_step")
        store = SnapshotStore(run)
        out["steps"] = store.list_steps()
        out["parents"] = [store.manifest(s)["parent"]
                          for s in out["steps"]]
        snaps = os.path.join(run, "snapshots")
        out["dirs"] = {d: sorted(os.listdir(os.path.join(snaps, d)))
                       for d in sorted(os.listdir(snaps))}
        out["refs"] = {s: sorted(store.referenced_steps(store.manifest(s)))
                       for s in out["steps"]}
        got = eng.restore()["s"]
        out["restored_equal"] = all(torch.equal(got[k], live["s"][k])
                                    for k in specs)
        return _report(group, os.path.join(root, "engine.json"), out)
''')

# JAX: the step-0 image (2 devices), the engine's reuse on 2 devices
_JAX_START = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.api import CheckpointOptions
    from repro.configs import get_smoke_config
    from repro.core import SnapshotEngine
    from repro.core.snapshot_io import SnapshotStore
    from repro.launch.mesh import make_host_mesh
    from repro.runtime.trainer import TrainConfig, Trainer
    from repro.sharding import get_policy

    out = os.environ["OUT_DIR"]
    mesh = make_host_mesh(data=2, model=1)
    tcfg = TrainConfig(batch_size=4, seq_len=16, lr=3e-4, total_steps=6,
                       ckpt_every=0, ckpt=CheckpointOptions(mode="sync"),
                       seed=0, compute_dtype=jnp.float32)
    t = Trainer(get_smoke_config("qwen1.5-0.5b"), tcfg, mesh,
                get_policy("baseline"), os.path.join(out, "start"))
    t.initialize()
    t.session.checkpoint(0)

    specs = {"a": (8, 6), "b": (5,), "c": (8, 4), "d": (3, 8)}
    parts = {"a": ("data",), "b": (), "c": ("data",), "d": (None, "data")}
    state = {k: jax.device_put(
        (np.arange(int(np.prod(s)), dtype=np.float32).reshape(s) / 7.0),
        NamedSharding(mesh, P(*parts[k]))) for k, s in specs.items()}
    run = os.path.join(out, "jax_engine")
    eng = SnapshotEngine(run, options=CheckpointOptions(incremental=True),
                         mesh=mesh)
    eng.attach(lambda: {"s": state})
    eng.checkpoint(1)
    for k in ("a", "b"):
        state[k] = state[k] + 1.0
    eng.checkpoint(2)
    man = SnapshotStore(run).manifest(2)
    with open(os.path.join(out, "jax_engine.json"), "w") as f:
        json.dump(sorted(n for n, loc in man["locations"].items()
                         if loc.startswith("step_00000001/")), f)
    print("JAX_OK")
""")

# JAX's launcher, --incremental from the step-0 image, on 2 devices
_JAX_LAUNCH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    from repro.launch import train
    rc = train.main(sys.argv[1:])
    print("JAX_OK" if not rc else "JAX_FAILED")
""")

# JAX restores port images onto 2 devices and onto 1
_JAX_RESTORE = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    from repro.core import SnapshotEngine
    from repro.core.device_plugin import flatten_with_paths
    from repro.launch.mesh import make_host_mesh

    out = os.environ["OUT_DIR"]
    for tag, run in json.loads(os.environ["RUNS"]).items():
        for n, mesh in (("two", make_host_mesh(data=2, model=1)),
                        ("one", None)):
            eng = SnapshotEngine(run, mesh=mesh)
            eng.attach(lambda: {"train_state": None})
            restored = eng.restore(step=6)["train_state"]
            flat = flatten_with_paths(restored)
            if mesh is not None:
                sizes = {len(v.sharding.device_set) for v in flat.values()}
                assert sizes == {2}, sizes
            np.savez(os.path.join(out, f"jax_{tag}_{n}.npz"),
                     **{k: np.asarray(v) for k, v in flat.items()})
    print("JAX_OK")
""")


#: jobs of this file running at once (each a process, or 2 ranks): the
#: other test files' workers share the host's cores
PARALLEL = 3


def _run_jobs(jobs, logs):
    """Run `jobs` ({name: (names it needs first, a zero-arg function that
    starts it and returns the process)}), at most PARALLEL at once, each
    once every job it needs has ended; {name: (exit code, stdout,
    stderr, seconds)}.  Output goes to files under `logs` (no pipe to
    fill), and a job past TIMEOUT_S is killed."""
    done, running = {}, {}
    while len(done) < len(jobs):
        for name, (needs, start) in jobs.items():
            if (name not in done and name not in running
                    and len(running) < PARALLEL
                    and all(n in done for n in needs)):
                running[name] = (start(), time.monotonic())
        for name, (proc, t0) in list(running.items()):
            if proc.poll() is None and time.monotonic() - t0 < TIMEOUT_S:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            del running[name]
            out, err = ((logs / f"{name}.{x}").read_text()
                        for x in ("out", "err"))
            done[name] = (proc.returncode, out, err, time.monotonic() - t0)
        time.sleep(0.05)
    return done


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of this file; the results by name, and the root
    directory."""
    root = tmp_path_factory.mktemp("dist_modes")
    (root / "dist_modes.py").write_text(_TARGETS)
    logs = root / "logs"
    logs.mkdir()
    jax_env = dict(_env(), OUT_DIR=str(root))
    start = root / "start"

    def job(name, argv, env=None):
        def go():
            with open(logs / f"{name}.out", "w") as out, \
                    open(logs / f"{name}.err", "w") as err:
                return subprocess.Popen([sys.executable, *argv],
                                        env=env or _env(), stdout=out,
                                        stderr=err, text=True, cwd=REPO)
        return go

    def launch(name, *args):
        return job(name, ["-m", "repro_torch.launch.train", *BASE, *args])

    def target(name, *argv):
        code = ("import sys\nfrom repro_torch.launch import dist\n"
                f"sys.exit(dist.launch('dist_modes:{name}', "
                f"{[str(a) for a in argv]!r}, 2, 'cpu', {str(root)!r}, "
                f"{float(BARRIER_S)!r}))")
        return job(name, ["-c", code], _env([str(root)]))

    def from_start(run, go):
        def start_it():
            shutil.copytree(start, root / run)
            return go()
        return start_it

    jobs = {
        "jax_start": ((), job("jax_start", ["-c", _JAX_START], jax_env)),
        "engine": ((), target("engine", root)),
        "gc_whole": ((), launch(
            "gc_whole", "--nproc", "2", "--incremental", "--keep", "1",
            "--steps", "8", "--ckpt-every", "2", "--run-dir",
            str(root / "gc"))),
        "gc_crash": ((), launch(
            "gc_crash", "--nproc", "2", "--incremental", "--keep", "1",
            "--steps", "8", "--ckpt-every", "2", "--fail-at", "5",
            "--run-dir", str(root / "gc_r"))),
        "gc_restore": (("gc_crash",), launch(
            "gc_restore", "--nproc", "2", "--incremental", "--keep", "1",
            "--steps", "8", "--ckpt-every", "2", "--restore", "--run-dir",
            str(root / "gc_r"))),
        "jax_inc": (("jax_start",), from_start("jax_inc", job(
            "jax_inc", ["-c", _JAX_LAUNCH, "--smoke", "--incremental",
                        "--restore", "--steps", str(STEPS), "--ckpt-every",
                        "2", "--ckpt-mode", "sync", "--keep", "0",
                        "--batch-size", "4", "--seq-len", "16",
                        "--run-dir", str(root / "jax_inc")], jax_env))),
        "base": (("jax_start",), from_start("base", launch(
            "base", "--nproc", "2", "--restore", "--keep", "0", "--steps",
            str(STEPS), "--ckpt-every", "1", "--run-dir",
            str(root / "base")))),
        "inc": (("jax_start",), from_start("inc", launch(
            "inc", "--nproc", "2", "--restore", "--incremental", "--keep",
            "0", "--steps", str(STEPS), "--ckpt-every", "2", "--run-dir",
            str(root / "inc")))),
        "concurrent": (("jax_start",), target("concurrent", root, start)),
        "replicate": (("jax_start",), target("replicate", root, start)),
        "kill_replica": (("jax_start",),
                         target("kill_replica", root, start)),
        "lazy": (("base",), target("lazy", root, root / "base")),
        "jax_restore": (("inc", "replicate"), job(
            "jax_restore", ["-c", _JAX_RESTORE], dict(jax_env, RUNS=json.dumps({
                "inc": str(root / "inc"),
                "replica_copy": str(root / "peer_copy"),
                "replica_delta": str(root / "peer_delta")})))),
    }
    res = _run_jobs(jobs, logs)
    res["root"] = root
    return res


def _read(root, name):
    with open(root / name) as f:
        return json.load(f)


def _losses(run, step=STEPS):
    r = SnapshotStore(str(run)).reader(step)
    try:
        return r.host_state()["trainer"]["loss_hist"]
    finally:
        r.close()


def _leaves(run, step):
    reader = SnapshotStore(str(run)).reader(step)
    try:
        return {k: assemble_global(reader.load_entry("train_state", k))
                for k, m in reader.meta["train_state"].items()
                if m["kind"] == "device_array"}
    finally:
        reader.close()


def _bits(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _jax_losses(runs):
    _ok(runs["jax_inc"])
    return _losses(runs["root"] / "jax_inc")


# ------------------------------------------------------------ (a) incremental
def test_incremental_launcher_matches_jax_losses_and_parents(runs):
    out = _ok(runs["inc"])
    assert _json(out)["snapshots"] == [0, 2, 4, 6]
    root = runs["root"]
    np.testing.assert_allclose(_losses(root / "inc"), _jax_losses(runs),
                               rtol=1e-4)
    ours, theirs = SnapshotStore(str(root / "inc")), \
        SnapshotStore(str(root / "jax_inc"))
    for step in (2, 4, 6):
        man = ours.manifest(step)
        assert man["parent"] == theirs.manifest(step)["parent"] == step - 2
        assert man["incremental"] is True and man["num_hosts"] == 2
        # one pack per rank, each written against the agreed parent
        assert {f.split(".")[0] for f in man["files"]} == {"host0000",
                                                          "host0001"}
        assert man["written_bytes"] + man["reused_bytes"] > 0


def test_jax_restores_the_incremental_two_rank_image(runs):
    out = _ok(runs["jax_restore"])
    assert "JAX_OK" in out
    root = runs["root"]
    leaves = _leaves(root / "inc", STEPS)
    for n in ("two", "one"):
        got = np.load(root / f"jax_inc_{n}.npz")
        assert sorted(got.files) == sorted(leaves)
        for k in got.files:
            assert np.array_equal(_bits(got[k]), _bits(leaves[k])), (n, k)


def test_engine_reuses_jax_entries_and_agrees_on_the_parent(runs):
    _ok(runs["engine"])
    got = _read(runs["root"], "engine.json")
    want = _read(runs["root"], "jax_engine.json")
    # the unchanged leaves' blocks, over both ranks, point into step 1
    assert want == sorted(["s::c::s0", "s::c::s1", "s::d::s0", "s::d::s1"])
    for rank in got:
        assert rank["reused"] == want
    # rank 1's store hid step 2: both wrote step 3 against rank 0's parent
    assert [r["parent_step"] for r in got] == [2, 2]
    assert got[0]["parents"] == [None, 1, 2]
    # keep=1: every rank's pack of a step an image reads from stays
    for s, refs in got[0]["refs"].items():
        for ref in refs:
            names = got[0]["dirs"][f"step_{ref:08d}"]
            assert {"host0000.pack.0", "host0001.pack.0"} <= set(names)
    assert all(r["restored_equal"] for r in got)


def test_incremental_keep_one_restart_is_bitwise(runs):
    whole = _json(_ok(runs["gc_whole"]))
    rc, out, err, _ = runs["gc_crash"]
    assert rc == 1, err[-3000:]
    back = _json(_ok(runs["gc_restore"]))
    assert "restored unified snapshot at step 4" in runs["gc_restore"][1]
    assert back["final_loss"] == whole["final_loss"]            # bitwise
    root = runs["root"]
    a, b = _leaves(root / "gc", 8), _leaves(root / "gc_r", 8)
    assert all(np.array_equal(_bits(a[k]), _bits(b[k])) for k in a)
    for run in (root / "gc", root / "gc_r"):
        store = SnapshotStore(str(run))
        for step in store.list_steps():
            for ref in store.referenced_steps(store.manifest(step)):
                names = os.listdir(snapshot_dir(str(run), ref))
                assert {"host0000.pack.0", "host0001.pack.0"} <= set(names)


# ------------------------------------------------------------- (b) lazy
def _rank_blocks(meta, rank):
    """The pack entries of the params that a rank restores: its block of
    a split leaf, the one block of a whole one."""
    names = []
    for path, m in meta.items():
        if m["kind"] != "device_array" or not path.startswith("params/"):
            continue
        i = rank if len(m["shards"]) == 2 else 0
        names.append(f"train_state::{path}::s{i}")
    return names


def test_lazy_restore_reads_only_its_critical_blocks(runs):
    _ok(runs["lazy"])
    got = _read(runs["root"], "lazy.json")
    reader = SnapshotStore(str(runs["root"] / "base")).reader(4)
    try:
        meta = reader.meta["train_state"]
    finally:
        reader.close()
    for rank, r in enumerate(got):
        want = sorted(_rank_blocks(meta, rank) + ["__host__", "__meta__"])
        assert r["critical_reads"] == want, rank
        assert not any("::opt/" in n for n in r["critical_reads"])


def test_lazy_losses_equal_eager_bitwise(runs):
    got = _read(runs["root"], "lazy.json")
    base = _losses(runs["root"] / "base")
    for r in got:
        assert r["eager"]["restored_at"] == r["lazy"]["restored_at"] == 4
        assert r["lazy"]["losses"] == r["eager"]["losses"] == base
        assert r["lazy"]["blocks"] == r["eager"]["blocks"]
    np.testing.assert_allclose(base, _jax_losses(runs), rtol=1e-4)


def test_torn_lazy_stream_falls_back_on_every_rank(runs):
    got = _read(runs["root"], "lazy.json")
    assert got[0]["torn_entry"].startswith("train_state::opt/m/")
    for r in got:
        t = r["torn"]
        assert t["restored_at"] == 4
        assert t["error"] == "LazyRestoreError"
        assert t["quarantined"] == [4]
        assert t["retry_at"] == 3
        assert t["losses"] == _losses(runs["root"] / "base")  # bitwise
        assert t["wall_s"] < BARRIER_S + 30        # no rank waited it out


# -------------------------------------------------------- (c) concurrent
def test_concurrent_images_equal_the_sync_images(runs):
    _ok(runs["concurrent"])
    root = runs["root"]
    got = _read(root, "concurrent.json")
    base = SnapshotStore(str(root / "base"))
    for kind in ("free", "held"):
        assert got[0][kind]["losses"] == _losses(root / "base")
        store = SnapshotStore(str(root / f"conc_{kind}"))
        steps = store.list_steps()
        assert steps == [0, 2, 4, 6], (kind, steps)
        for step in steps[1:]:
            man = store.manifest(step)
            assert man["capture"] == "concurrent" and man["num_hosts"] == 2
            r = store.reader(step)
            try:
                at = r.host_state()["trainer"]["step"]
            finally:
                r.close()
            want = base.manifest(at)["entry_crcs"]
            ours = {k: v for k, v in man["entry_crcs"].items()
                    if k.startswith("train_state::")}
            assert ours == {k: v for k, v in want.items()
                            if k.startswith("train_state::")}, (kind, step)
    np.testing.assert_allclose(got[0]["free"]["losses"], _jax_losses(runs),
                               rtol=1e-4)


@pytest.mark.parametrize("kind", ["free", "held"])
def test_ranks_validate_each_capture_at_the_same_step(runs, kind):
    got = _read(runs["root"], "concurrent.json")
    done = [r[kind]["finalized"] for r in got]
    assert done[0] == done[1]                  # same image, same step
    assert [c for c, _ in done[0]] == [2, 4, 6]
    assert all(c <= at for c, at in done[0])
    # rank 1's speculation was held back at each image, rank 0's not
    assert [r[kind]["held"] for r in got] == (
        [[], [2, 4, 6]] if kind == "held" else [[], []])


# ------------------------------------------------------- (d) replication
@pytest.mark.parametrize("mode", ["copy", "delta"])
def test_replica_holds_every_pack_and_restores_bitwise(runs, mode):
    root = runs["root"]
    got = _read(root, "replicate.json")
    base = _losses(root / "base")
    peer = SnapshotStore(str(root / f"peer_{mode}"))
    assert peer.list_steps() == [2, 4, 6]
    for step in peer.list_steps():
        files = set(os.listdir(snapshot_dir(str(root / f"peer_{mode}"),
                                            step)))
        assert {"host0000.pack.0", "host0000.pack.1", "host0001.pack.0",
                "host0001.pack.1", MANIFEST} <= files, (step, files)
        assert not any(f.startswith("PREPARED") for f in files)
    for r in got:
        rec = r[mode]
        assert rec["losses"] == base
        assert rec["restored_at"] == STEPS and rec["from_replica"] is True
        assert rec["restored_blocks"] == rec["blocks"]     # bitwise
        assert len(rec["pushes"]) == 3 and all(
            p["replicate_s"] > 0 for p in rec["pushes"])
    if mode == "delta":
        log = json.load(open(root / f"peer_{mode}" / ".cas"
                             / "transfers.json"))
        assert sorted((e["step"], e["rank"]) for e in log) == [
            (s, r) for s in (2, 4, 6) for r in (0, 1)]
        assert all(e["chunks_sent"] + e["chunks_reused"] > 0 for e in log)


def test_jax_restores_the_replica(runs):
    _ok(runs["jax_restore"])
    root = runs["root"]
    leaves = _leaves(root / "rep_copy_primary", STEPS)
    for mode in ("copy", "delta"):
        for n in ("two", "one"):
            got = np.load(root / f"jax_replica_{mode}_{n}.npz")
            for k in got.files:
                assert np.array_equal(_bits(got[k]), _bits(leaves[k])), \
                    (mode, n, k)


def test_a_rank_killed_mid_push_leaves_no_replica_manifest(runs):
    rc, out, err, waited = runs["kill_replica"]
    assert rc == 1, err[-3000:]
    assert "prepared within" in err, err[-3000:]
    assert waited < BARRIER_S + 60
    root = runs["root"]
    assert SnapshotStore(str(root / "rep_kill")).list_steps() == [0, 2, 4]
    assert SnapshotStore(str(root / "peer_kill")).list_steps() == [2]
    torn = os.listdir(snapshot_dir(str(root / "peer_kill"), 4))
    assert MANIFEST not in torn and "host0001.pack.0" in torn

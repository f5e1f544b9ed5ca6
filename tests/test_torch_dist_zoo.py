"""The rest of the smoke zoo across processes: two gloo ranks on the CPU.

``tests/test_torch_dist.py`` holds smoke qwen1.5 and mamba2 at 2 ranks
against the JAX package's Trainer on a 2-device mesh; this file does the
same for the other arches of the zoo: qwen3-moe-30b-a3b (MoE with
q/k-norm), h2o-danube-1.8b (a sliding window), jamba-v0.1-52b (the
attention-Mamba-MoE hybrid), whisper-tiny (encoder-decoder) and
qwen2-vl-7b (vision embeddings, M-RoPE).  Each runs 6 steps of the train
launcher's rank (global batch 4 x 16; qwen2-vl 4 x 24, its 16 vision rows,
which the loss masks, and 8 text tokens; baseline policy over
``make_host_mesh(data=2, model=1)``) from JAX's step-0 image, and is
held to JAX's 2-device run: losses within rtol 1e-4, and JAX's losses
non-zero (a batch whose loss mask drops every token trains nothing and
would hold nothing); the step-6 params within 1e-4 of each leaf's max,
or, where the reference itself moves a leaf more than that when its
reduction order changes (its 6 steps on one device against its 6 on
two), within that spread; and the 2-rank run within 1e-4 (or twice the
reference's own spread) of the port's own one-process run (in the
test's process).  Elements whose grads sit at the rounding floor each
take Adam's +-lr by a sign of rounding, as ROADMAP C records for
qwen1.5's biases: whisper-tiny's ``embed/tok`` (the reference's own
spread 4.3e-4, the port 4.1e-4 from its 2-device run), and qwen2-vl's
``embed/tok`` (5 elements of 3 rows), where the packages already part
at one device by more than the reference's own spread: that one leaf
(``ONE_DEVICE_SPREAD``) is held within the packages' one-device spread
(the port's one-process run against the reference's one-device run)
where that is larger, and the test prints its readings (``-s``; a CPU
run: the port's 2 ranks 5.22e-4 of the leaf's max from JAX's 2 devices,
the reference's own spread 1.42e-5, the packages' at one device
5.24e-4).  Every other leaf of the five arches passes at max(1e-4, the
reference's own spread).

jamba runs with SSD chunks of 4 (``ssm_chunk=4``, both packages): at
its smoke config's chunks of 8 the reference's intra-chunk decay
``jnp.where(mask, jnp.exp(diff), 0.0)`` (``src/repro/models/mamba.py:114``)
overflows where the mask drops it, and the backward's 0 x inf makes the
first step's grads NaN (ROADMAP C's limits of the reference; held below
on the JAX side at the default chunk).

MoE's aux loss is compared on its own, step by step: the reference
``pmean``s it over the data axis (each data shard routes its own tokens,
``src/repro/models/moe.py:114-115, :141-146``); each rank of the port
routes its own rows, and the mean of the ranks' aux losses is held to
JAX's within rtol 1e-4.

JAX runs in three subprocesses with 2 host devices (jamba's 2-device and
1-device runs apart: its compile is the longest); each port run starts as soon as its arch's
step-0 image is written, at most PARALLEL runs at once.  Every subprocess has one
torch thread per rank and is bounded by a timeout from its own start.
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
from repro_torch.core.snapshot_io import SnapshotStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCHS = ("qwen3-moe-30b-a3b", "h2o-danube-1.8b", "jamba-v0.1-52b",
         "whisper-tiny", "qwen2-vl-7b")
MOE = ("qwen3-moe-30b-a3b", "jamba-v0.1-52b")
JAMBA = "jamba-v0.1-52b"
#: config overrides of the smoke configs, in both packages: jamba's SSD
#: chunk at which the reference's grads stay finite
OVERRIDES = {JAMBA: {"ssm_chunk": 4}}
#: the training batch's sequence: 16, but qwen2-vl's 16 vision rows and 8
#: text tokens (at 16 its loss mask drops every token)
SEQ = {"qwen2-vl-7b": 24}
#: the leaves held to the packages' own spread at one device where that is
#: larger than the reference's (module docstring): qwen2-vl's embedding
ONE_DEVICE_SPREAD = {"qwen2-vl-7b": ("embed/tok",)}
#: port runs at once (2 ranks each) beside the JAX processes: the other
#: test files' workers share the host's cores
PARALLEL = 2
STEPS = 6
#: per subprocess, from its own start; the ranks' own deadline is far
#: below it (BARRIER_S, the group's timeout).  Under the tier-1 command
#: (six xdist workers, --dist loadfile) JAX's jamba 2-device process took
#: up to 199 s (95 s with nothing beside it): twice that
TIMEOUT_S = 400
BARRIER_S = 30


def _env(extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + (extra or [])))
    env.pop("XLA_FLAGS", None)
    return env


def _start(argv, env=None):
    """A started subprocess, with its own deadline: TIMEOUT_S from now."""
    proc = subprocess.Popen([sys.executable, *argv], env=env or _env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO)
    proc.deadline = time.monotonic() + TIMEOUT_S
    return proc


def _finish(proc):
    """(exit code, stdout, stderr) of a started process, killed past its
    own deadline."""
    try:
        out, err = proc.communicate(
            timeout=max(proc.deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"timed out: {proc.args}\n{err[-3000:]}")
    return proc.returncode, out, err


_TARGET = textwrap.dedent('''
    """The train launcher's rank, recording each step's MoE aux loss."""
    import json

    from repro_torch.launch import train
    from repro_torch.runtime.trainer import Trainer


    def zoo(argv, group):
        """argv: the aux losses' file, the smoke config's overrides
        (JSON), the launcher's arguments."""
        from repro_torch.configs import get_smoke_config
        out, overrides, *rest = argv
        cfg = get_smoke_config(rest[rest.index("--arch") + 1],
                               **json.loads(overrides))
        aux = []
        step = Trainer._train_step

        def recorded(self, batch):
            metrics = step(self, batch)
            if "aux_loss" in metrics:
                aux.append(float(metrics["aux_loss"]))
            return metrics
        Trainer._train_step = recorded
        rc = train.rank_main(rest, group, cfg=cfg)
        got = group.gather_objects(aux)
        if group.rank == 0:
            with open(out, "w") as f:
                json.dump(got, f)
        return rc
''')

# argv: OUT_DIR, "two" | "one" | "both" (2 devices, 1, or 2 then 1),
# overrides (JSON), arches
_JAX_TRAIN = f"SEQ = {SEQ!r}\n" + textwrap.dedent("""
    import os, shutil, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.api import CheckpointOptions
    from repro.configs import get_smoke_config
    from repro.core.device_plugin import flatten_with_paths
    from repro.launch.mesh import make_host_mesh
    from repro.runtime.trainer import TrainConfig, Trainer
    from repro.sharding import get_policy

    out, which, overrides = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    datas = {"two": (2,), "one": (1,), "both": (2, 1)}[which]
    for arch in sys.argv[4:]:
        cfg = get_smoke_config(arch, **overrides.get(arch, {}))
        run = os.path.join(out, arch, "jax_run")
        tcfg = TrainConfig(batch_size=4, seq_len=SEQ.get(arch, 16),
                           lr=3e-4, total_steps=6, ckpt_every=0,
                           ckpt=CheckpointOptions(mode="sync", keep=0),
                           seed=0, compute_dtype=jnp.float32)
        for data in datas:
            tag = "" if data == 2 else "_one"
            t = Trainer(cfg, tcfg, make_host_mesh(data=data, model=1),
                        get_policy("baseline"), run + tag)
            t.initialize()
            if data == 2:
                t.session.checkpoint(0)
                shutil.copytree(run, os.path.join(out, arch, "start"))
                open(os.path.join(out, arch, "start_ready"), "w").close()
            aux, step_fn = [], t._step_fn

            def recorded(p, o, b, step_fn=step_fn, aux=aux):
                p, o, m = step_fn(p, o, b)
                if "aux_loss" in m:
                    aux.append(float(m["aux_loss"]))
                return p, o, m
            t._step_fn = recorded
            t.run(6)
            if data == 2:
                with open(os.path.join(out, arch, "jax.json"), "w") as f:
                    json.dump({"losses": t.metrics_history["loss"],
                               "aux": aux}, f)
            np.savez(os.path.join(out, arch, f"params{tag}.npz"),
                     **{k: np.asarray(v) for k, v in
                        flatten_with_paths(t.params).items()})
        if arch in overrides and 2 in datas:
            # the first step's grads at the smoke config's own value
            from repro.launch.mesh import use_mesh
            t = Trainer(get_smoke_config(arch), tcfg,
                        make_host_mesh(data=2, model=1),
                        get_policy("baseline"), run + "_default")
            t.initialize()
            batch = {k: jnp.asarray(v) for k, v in t.pipeline.next().items()}
            with use_mesh(t.mesh):
                (_, m), g = jax.value_and_grad(
                    lambda p: t.model.loss(p, batch), has_aux=True)(t.params)
            bad = sorted(k for k, v in flatten_with_paths(g).items()
                         if not np.isfinite(np.asarray(v)).all())
            with open(os.path.join(out, arch, "default.json"), "w") as f:
                json.dump({"loss": float(m["loss"]),
                           "nonfinite_grads": bad}, f)
    print("JAX_OK")
""")


def _launch_port(root, arch):
    port = root / arch / "port"
    shutil.copytree(root / arch / "start", port)
    argv = [str(root / arch / "aux.json"),
            json.dumps(OVERRIDES.get(arch, {})), "--arch", arch, "--smoke",
            "--device", "cpu", "--batch-size", "4", "--seq-len",
            str(SEQ.get(arch, 16)),
            "--steps", str(STEPS), "--ckpt-every", str(STEPS),
            "--ckpt-mode", "sync", "--keep", "0", "--restore",
            "--dist-timeout", str(BARRIER_S), "--run-dir", str(port)]
    code = ("import sys\nfrom repro_torch.launch import dist\n"
            f"sys.exit(dist.launch('dist_zoo:zoo', {argv!r}, 2, 'cpu', "
            f"{str(port)!r}, {float(BARRIER_S)!r}))")
    return _start(["-c", code], _env([str(root)]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs, and each arch's port run once its step-0 image is
    there; {arch: (exit code, stdout, stderr)} and the root."""
    root = tmp_path_factory.mktemp("dist_zoo")
    (root / "dist_zoo.py").write_text(_TARGET)
    rest = [a for a in ARCHS if a != JAMBA]
    over = json.dumps(OVERRIDES)
    jax = [_start(["-c", _JAX_TRAIN, str(root), "two", over, JAMBA]),
           _start(["-c", _JAX_TRAIN, str(root), "one", over, JAMBA]),
           _start(["-c", _JAX_TRAIN, str(root), "both", over, *rest])]
    port, res = {}, {}
    while len(res) < len(ARCHS):
        for arch in ARCHS:
            if (arch not in port and len(port) - len(res) < PARALLEL
                    and (root / arch / "start_ready").exists()):
                port[arch] = _launch_port(root, arch)
        for arch, p in port.items():
            if arch not in res and p.poll() is not None:
                res[arch] = _finish(p)
        if any(p.poll() not in (None, 0) for p in jax) or any(
                p.poll() is None and time.monotonic() > p.deadline
                for p in [*jax, *port.values()]):
            break
        time.sleep(0.2)
    res["jax"] = [_finish(p) for p in jax]
    for arch, p in port.items():
        if arch not in res:
            res[arch] = _finish(p)
    res["root"] = root
    return res


def _close(ours, theirs, spread=None):
    """Each leaf of `ours` within 1e-4 of `theirs`'s max, or within the
    reference's own `spread` ({leaf: the same measure between its runs
    on one device and on two}) where that is larger."""
    for k, t in theirs.items():
        o = ours[f"params/{k}"]
        scale = max(float(np.abs(t).max()), 1e-30)
        tol = max(1e-4, (spread or {}).get(k, 0.0))
        assert np.abs(o - t).max() <= tol * scale, (k, tol)


def _port_one(root, arch):
    """The port's step-6 params of one process (no mesh) from JAX's
    step-0 image, as the train launcher's rank configures its trainer."""
    import torch

    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    run = root / arch / "port_one"
    shutil.copytree(root / arch / "start", run)
    tcfg = TrainConfig(batch_size=4, seq_len=SEQ.get(arch, 16), lr=3e-4,
                       total_steps=STEPS, ckpt_every=0,
                       ckpt=CheckpointOptions(mode="sync", keep=0), seed=0,
                       compute_dtype=torch.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = Trainer(get_smoke_config(arch, **OVERRIDES.get(arch, {})), tcfg,
                    str(run), device="cpu")
        assert t.restore() == 0
        t.run(STEPS)
    finally:
        torch.set_num_threads(threads)
    return {f"params/{k}": v.numpy()
            for k, v in flatten_with_paths(t.params).items()}


def _leaves(run, step):
    reader = SnapshotStore(run).reader(step)
    try:
        return {k: assemble_global(reader.load_entry("train_state", k))
                for k, m in reader.meta["train_state"].items()
                if m["kind"] == "device_array"}, reader.host_state()
    finally:
        reader.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_train_the_zoo_to_the_jax_losses_and_params(runs, arch):
    for rc, out, err in runs["jax"]:
        assert rc == 0 and "JAX_OK" in out, err[-3000:]
    rc, out, err = runs[arch]
    assert rc == 0, err[-3000:]
    assert "restored unified snapshot at step 0" in out
    root = runs["root"] / arch
    with open(root / "jax.json") as f:
        want = json.load(f)
    assert len(want["losses"]) == STEPS and all(want["losses"])
    leaves, host = _leaves(str(root / "port"), STEPS)
    np.testing.assert_allclose(host["trainer"]["loss_hist"],
                               want["losses"], rtol=1e-4)
    params = dict(np.load(root / "params.npz"))
    one = np.load(root / "params_one.npz")
    assert sorted(f"params/{k}" for k in params) == sorted(
        k for k in leaves if k.startswith("params/"))
    port_one = _port_one(runs["root"], arch)

    def dist(a, t):
        return float(np.abs(a - t).max()) / max(float(np.abs(t).max()),
                                                1e-30)
    # the reference's own spread when its reduction order changes
    spread = {k: dist(one[k], t) for k, t in params.items()}
    bound = dict(spread)
    for k in ONE_DEVICE_SPREAD.get(arch, ()):
        # the packages already part at one device (module docstring)
        bound[k] = max(spread[k], dist(port_one[f"params/{k}"], one[k]))
        print(f"{arch} {k}: {dist(leaves[f'params/{k}'], params[k]):.4e} "
              f"of its max; the reference's own spread {spread[k]:.4e}, "
              f"the packages' at one device {bound[k]:.4e}")
    _close(leaves, params, bound)
    # the port's own 2-rank run against its one-process run: MoE routing
    # per rank and reduction order move it as they move the reference
    # (qwen3-moe's embed/tok and jamba's dt_bias at 1.00-1.02x the
    # reference's own spread), so twice that spread, as
    # tests/test_torch_dist_ep_zoo.py holds its (2, 2) run to its (1, 1)
    _close(leaves, {k[len("params/"):]: v for k, v in port_one.items()},
           {k: 2 * s for k, s in spread.items()})


def test_jax_jamba_grads_at_the_default_chunk_are_not_finite(runs):
    """The reference's limit that ``OVERRIDES`` steps round: its first
    step's grads at jamba's smoke chunk of 8 (the port's are finite:
    tests/test_torch_trainer.py trains smoke jamba bitwise)."""
    for rc, out, err in runs["jax"]:
        assert rc == 0 and "JAX_OK" in out, err[-3000:]
    with open(runs["root"] / JAMBA / "default.json") as f:
        got = json.load(f)
    assert np.isfinite(got["loss"])
    assert "blocks/pos0/mamba/A_log" in got["nonfinite_grads"]


@pytest.mark.parametrize("arch", MOE)
def test_moe_aux_loss_is_the_mean_over_ranks_of_the_jax_pmean(runs, arch):
    rc, out, err = runs[arch]
    assert rc == 0, err[-3000:]
    root = runs["root"] / arch
    with open(root / "jax.json") as f:
        want = json.load(f)["aux"]
    with open(root / "aux.json") as f:
        ranks = json.load(f)
    assert len(want) == STEPS and [len(r) for r in ranks] == [STEPS] * 2
    np.testing.assert_allclose(np.mean(ranks, axis=0), want, rtol=1e-4)

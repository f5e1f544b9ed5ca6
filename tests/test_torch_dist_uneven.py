"""A batch that the data ranks do not divide: two gloo ranks on the CPU.

The reference accepts one: its Trainer takes a global batch of 3 rows on
2 devices, and its DecodeServer a batch of 1.  Its layout then leaves the
batch dim unsharded (``fit_spec`` drops the data axis from a dim it does
not divide), and its MoE block splits the flat tokens over the data axis
where they divide (3 x 16 = 48 tokens: 24 a shard, the aux loss
``pmean``-ed) and routes every token on every shard where they do not (a
decode step's 1 token; ``src/repro/models/moe.py:140-146``).  The port
follows it: every rank takes such a batch whole (``sharding.policy.
row_axes``), and its MoE routes each of the reference's token shards on
its own (``ExpertShard.token_shards``).  Before that the port raised
("does not divide over a data size").

Smoke qwen3-moe-30b-a3b, f32, baseline policy on ``(data=2, model=1)``:
  * training B 3 x 16, 3 steps from JAX's step-0 image: losses and aux
    losses within rtol 1e-4 of JAX's 2-device run; the step-3 params
    within 1e-4 of each leaf's max, or the reference's own spread (its
    one-device run against its two-device run) where that is larger;
  * serving a batch of 1 (prompt 8, 6 tokens, an image at token 3):
    JAX's 2-device tokens, and again after a cold restore of the port's
    image (whose cache splits its seq dim over ``data``, the batch dim
    being whole).

One JAX subprocess with 2 host devices, then one 2-rank launch, each
bounded by TIMEOUT_S from its own start.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.core.device_plugin import assemble_global
from repro_torch.core.snapshot_io import SnapshotStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCH = "qwen3-moe-30b-a3b"
B, S, STEPS = 3, 16, 3
PROMPT, TOKENS, AT, MAX_SEQ = 8, 6, 3, 32
TIMEOUT_S = 300
BARRIER_S = 30.0

_COMMON = (f"ARCH, B, S, STEPS = {ARCH!r}, {B}, {S}, {STEPS}\n"
           f"PROMPT, TOKENS, AT, MAX_SEQ = {PROMPT}, {TOKENS}, {AT}, "
           f"{MAX_SEQ}\n")

_JAX = _COMMON + textwrap.dedent("""
    import os, json, pickle, shutil, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.api import CheckpointOptions
    from repro.configs import get_smoke_config
    from repro.core.device_plugin import flatten_with_paths
    from repro.data import TokenPipeline
    from repro.launch.mesh import make_host_mesh
    from repro.models.encdec import build_model
    from repro.runtime.server import DecodeServer
    from repro.runtime.trainer import TrainConfig, Trainer
    from repro.sharding import get_policy

    root = sys.argv[1]
    cfg, pol = get_smoke_config(ARCH), get_policy("baseline")
    tcfg = TrainConfig(batch_size=B, seq_len=S, lr=3e-4, total_steps=STEPS,
                       ckpt_every=0, ckpt=CheckpointOptions(mode="sync",
                                                            keep=0),
                       seed=0, compute_dtype=jnp.float32)
    out = {}
    for data in (2, 1):
        t = Trainer(cfg, tcfg, make_host_mesh(data=data, model=1), pol,
                    os.path.join(root, f"jax{data}"))
        t.initialize()
        if data == 2:
            t.session.checkpoint(0)
            shutil.copytree(os.path.join(root, "jax2"),
                            os.path.join(root, "start"))
        aux, step_fn = [], t._step_fn

        def recorded(p, o, b, step_fn=step_fn, aux=aux):
            p, o, m = step_fn(p, o, b)
            aux.append(float(m["aux_loss"]))
            return p, o, m
        t._step_fn = recorded
        t.run(STEPS)
        out[data] = {"losses": t.metrics_history["loss"], "aux": aux}
        np.savez(os.path.join(root, f"jax_params{data}.npz"),
                 **{k: np.asarray(v)
                    for k, v in flatten_with_paths(t.params).items()})
    mesh = make_host_mesh(data=2, model=1)
    model = build_model(cfg, pol, mesh, compute_dtype=jnp.float32,
                        remat=False)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        model.init_abstract())
    with open(os.path.join(root, "params.pkl"), "wb") as f:
        pickle.dump(params, f)
    batch = TokenPipeline(cfg, 1, PROMPT, seed=0).next()
    np.savez(os.path.join(root, "batch.npz"), **batch)
    srv = DecodeServer(cfg, pol, mesh, os.path.join(root, "jax_serve"),
                       max_seq=MAX_SEQ, model=model)
    srv.load(jax.device_put(params, model.param_shardings()))
    srv.start(batch)
    srv.decode(TOKENS)
    out["tokens"] = srv.tokens.tolist()
    with open(os.path.join(root, "jax.json"), "w") as f:
        json.dump(out, f)
    print("JAX_OK")
""")

_RANKS = _COMMON + textwrap.dedent('''
    """Each rank of the port's 2-rank run."""
    import json, pickle, shutil

    import numpy as np
    import torch

    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.encdec import build_model
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.runtime.trainer import TrainConfig, Trainer


    def main(argv, group):
        root = argv[0]
        torch.manual_seed(0)
        cfg = get_smoke_config(ARCH)

        def mesh():
            return make_host_mesh(data=2, model=1, device="cpu", group=group)
        run = f"{root}/port"
        if group.rank == 0:
            shutil.copytree(f"{root}/start", run)
        group.all_ranks(True)
        t = Trainer(cfg, TrainConfig(
            batch_size=B, seq_len=S, lr=3e-4, total_steps=STEPS,
            ckpt_every=STEPS, ckpt=CheckpointOptions(mode="sync", keep=0),
            seed=0, compute_dtype=torch.float32), run, mesh=mesh(),
            device="cpu")
        assert t.restore() == 0
        aux, step = [], t._train_step

        def recorded(batch):
            m = step(batch)
            aux.append(float(m["aux_loss"]))
            return m
        t._train_step = recorded
        t.run(STEPS)
        report = {"losses": t.metrics_history["loss"], "aux": aux}
        t.release()

        model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                            device="cpu")
        with open(f"{root}/params.pkl", "rb") as f:
            params = params_from_numpy(pickle.load(f), "cpu")
        batch = dict(np.load(f"{root}/batch.npz"))

        def server():
            return DecodeServer(cfg, f"{root}/serve", max_seq=MAX_SEQ,
                                model=model, mesh=mesh())
        srv = server()
        srv.load(params)
        srv.start(batch)
        srv.decode(AT)
        srv.checkpoint(0)
        srv.decode(TOKENS - AT)
        report["tokens"] = srv.tokens.tolist()
        srv.release()
        cold = server()
        assert cold.restore() == PROMPT + AT
        cold.decode(TOKENS - AT)
        report["cold"] = cold.tokens.tolist()
        cold.release()
        reports = group.gather_objects(report)
        if group.rank == 0:
            with open(f"{root}/port.json", "w") as f:
                json.dump(reports, f)
        return 0
''')


def _env(extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + (extra or [])))
    env.pop("XLA_FLAGS", None)
    return env


def _run(what, argv, env=None) -> str:
    """A subprocess run to its end, bounded by TIMEOUT_S from its start;
    its stdout."""
    proc = subprocess.Popen([sys.executable, *argv], env=env or _env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"timed out: {what}\n{err[-3000:]}")
    assert proc.returncode == 0, f"{what}\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs, then the port's 2-rank run; (JAX's numbers, each
    rank's report, the root)."""
    root = tmp_path_factory.mktemp("dist_uneven")
    (root / "uneven_ranks.py").write_text(_RANKS)
    assert "JAX_OK" in _run("JAX", ["-c", _JAX, str(root)])
    code = ("import sys\nfrom repro_torch.launch import dist\n"
            f"sys.exit(dist.launch('uneven_ranks:main', {[str(root)]!r}, 2, "
            f"'cpu', {str(root / 'launch')!r}, {BARRIER_S!r}))")
    _run("port", ["-c", code], _env([str(root)]))
    with open(root / "jax.json") as f:
        jax = json.load(f)
    with open(root / "port.json") as f:
        port = json.load(f)
    return jax, port, root


def test_row_axes_keep_the_data_axes_that_divide_the_batch():
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.policy import row_axes
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    assert row_axes(mesh, ("pod", "data"), 4) == ("data",)
    assert row_axes(mesh, ("pod", "data"), 3) == ()
    assert row_axes(mesh, ("pod", "data"), 1) == ()
    assert row_axes(mesh, ("data", "model"), 6) == ("data",)
    assert row_axes(mesh, ("data", "model"), 8) == ("data", "model")
    assert row_axes(mesh, (), 3) == ()


def test_two_ranks_train_an_undivided_batch_as_jax_does(runs):
    jax, port, root = runs
    want = jax["2"]
    assert len(want["losses"]) == STEPS and all(want["losses"])
    for rep in port:
        np.testing.assert_allclose(rep["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(rep["aux"], want["aux"], rtol=1e-4)
    reader = SnapshotStore(str(root / "port")).reader(STEPS)
    try:
        got = {k: assemble_global(reader.load_entry("train_state", k))
               for k, m in reader.meta["train_state"].items()
               if m["kind"] == "device_array" and k.startswith("params/")}
    finally:
        reader.close()
    two = dict(np.load(root / "jax_params2.npz"))
    one = np.load(root / "jax_params1.npz")
    assert sorted(got) == sorted(f"params/{k}" for k in two)
    for k, t in two.items():
        scale = max(float(np.abs(t).max()), 1e-30)
        spread = float(np.abs(one[k] - t).max()) / scale
        assert np.abs(got[f"params/{k}"] - t).max() <= max(
            1e-4, spread) * scale, k


def test_two_ranks_serve_a_batch_of_one_as_jax_does(runs):
    jax, port, _ = runs
    assert np.asarray(jax["tokens"]).shape == (1, PROMPT + 1 + TOKENS)
    for rep in port:
        assert rep["tokens"] == jax["tokens"]
        assert rep["cold"] == jax["tokens"]

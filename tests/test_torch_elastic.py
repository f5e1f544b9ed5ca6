"""Elastic restore in the port, held against the JAX package's layouts
and images.

One JAX subprocess with 8 host CPU devices (the reference's own posture,
tests/test_restore_elastic.py:36-40) does two things: it dumps JAX's
block map and replica ids, per mesh coordinate, for a grid of (mesh,
spec, shape) cases, and it writes the reference's elastic image: the
smoke qwen1.5 train state on a (4, 2) ``("data", "model")`` mesh at step
3, beside the state as numpy.  The port's ``NamedSharding`` must give
JAX's block map and replica ids at every case (and raise where JAX
raises); the port restores JAX's image onto (2, 2) and (1, 1) CPU meshes
"resharded" and onto a (4, 2) mesh "identical", bit-equal; the port's own
(4, 2) image of the same state names the same entries, shapes, dtypes,
descriptors and shard-index sets as JAX's, and the JAX package restores
it whole, bit-exact.  Last, the port's trainer state moves between
(4, 2), (2, 2) and (1, 1) meshes with ``elastic_restore`` and the next
step equals the uninterrupted one bitwise.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import flatten_with_paths, unflatten_paths
from repro_torch.core.snapshot_io import SnapshotStore
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models.encdec import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import OptState
from repro_torch.optim.schedule import constant
from repro_torch.runtime.elastic import elastic_restore
from repro_torch.runtime.trainer import TrainConfig, Trainer
from repro_torch.sharding import NamedSharding, PartitionSpec, state_shardings
from repro_torch.sharding.policy import index_to_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16)

MESHES = [((8,), ("data",)), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
SPECS = [[], [None], ["data"], [None, "data"], [["data", "model"]],
         ["model", "data"], [["model", "data"], None],
         [["pod", "data"], "model"], [None, ["model", "pod"]], ["pod"],
         [["data", "pod"]]]
SHAPES = [(), (16,), (16, 8), (8, 16, 4), (6, 4)]
CASES = [(list(m), list(n), s, list(shape))
         for m, n in MESHES for s in SPECS for shape in SHAPES
         if all(a in n for e in s if e is not None
                for a in (e if isinstance(e, list) else [e]))
         and len(s) <= len(shape)]


def _case_id(case):
    m, _, s, shape = case
    return f"{'x'.join(map(str, m))}-{json.dumps(s)}-{tuple(shape)}"


_JAX_SCRIPT = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_mesh, use_mesh
    from repro.configs import get_smoke_config
    from repro.core import SnapshotEngine
    from repro.core.device_plugin import flatten_with_paths
    from repro.models.encdec import build_model
    from repro.optim import AdamW
    from repro.sharding import get_policy

    out_dir = os.environ["OUT_DIR"]
    layouts = {}
    for i, (mshape, names, spec, shape) in enumerate(
            json.loads(os.environ["CASES"])):
        mesh = make_mesh(tuple(mshape), tuple(names))
        where = {d.id: [int(x) for x in np.argwhere(mesh.devices == d)[0]]
                 for d in mesh.devices.flat}
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        try:
            arr = jax.device_put(np.zeros(shape, np.float32),
                                 NamedSharding(mesh, spec))
        except ValueError:
            layouts[i] = None
            continue
        layouts[i] = {
            json.dumps(where[s.device.id]): [
                [[0 if sl.start is None else sl.start,
                  dim if sl.stop is None else sl.stop]
                 for sl, dim in zip(s.index, shape)], s.replica_id]
            for s in arr.addressable_shards}
    with open(os.path.join(out_dir, "layouts.json"), "w") as f:
        json.dump(layouts, f)

    # the reference's elastic image (tests/test_restore_elastic.py)
    cfg = get_smoke_config("qwen1.5-0.5b", d_model=64, num_heads=4,
                           num_kv_heads=4, head_dim=16)
    mesh = make_mesh((4, 2), ("data", "model"))
    model = build_model(cfg, get_policy("baseline"), mesh,
                        compute_dtype=jnp.float32, remat=False)
    with use_mesh(mesh):
        params = jax.jit(model.init, out_shardings=model.param_shardings())(
            jax.random.key(0))
        opt_state = AdamW(lr=lambda s: 1e-3).init(params)
        # a non-trivial optimizer state: m and v from the params
        opt_state = type(opt_state)(
            step=opt_state.step + 3,
            m=jax.tree.map(lambda p: p * 0.5, params),
            v=jax.tree.map(lambda p: p * p, params))
    state = {"params": params, "opt": opt_state}
    engine = SnapshotEngine(os.path.join(out_dir, "jax_run"), mesh=mesh)
    engine.attach(lambda: {"train_state": state})
    engine.register_host_state("trainer", lambda: {"step": 3},
                               lambda st: None)
    engine.register_host_state("data_cursor", lambda: {"step": 3},
                               lambda st: None)
    engine.checkpoint(3)
    np.savez(os.path.join(out_dir, "state.npz"),
             **{k: np.asarray(v) for k, v in
                flatten_with_paths(state).items()})
    print("JAX_OK")
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_elastic")
    env = dict(os.environ, OUT_DIR=str(out), CASES=json.dumps(CASES),
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "JAX_OK" in r.stdout
    with open(out / "layouts.json") as f:
        layouts = json.load(f)
    npz = np.load(out / "state.npz")
    return {"layouts": layouts, "run": str(out / "jax_run"),
            "state": {k: npz[k] for k in npz.files}, "dir": out}


def _model():
    return build_model(get_smoke_config("qwen1.5-0.5b", **SMOKE),
                       compute_dtype=torch.float32, remat=False,
                       device="cpu")


def _mesh(*shape):
    return make_mesh(shape, ("data", "model"), devices="cpu")


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_block_map_and_replica_ids_match_jax(jax_side, i):
    mshape, names, spec, shape = CASES[i]
    want = jax_side["layouts"][str(i)]
    mesh = make_mesh(tuple(mshape), tuple(names), devices="cpu")
    spec = PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                           for e in spec])
    sh = NamedSharding(mesh, spec)
    if want is None:
        with pytest.raises(ValueError):
            sh.devices_indices_map(tuple(shape))
        return
    idx = sh.devices_indices_map(tuple(shape))
    rid = sh.replica_ids(tuple(shape))
    got = {json.dumps(list(c)): [index_to_json(idx[c], shape), rid[c]]
           for c in idx}
    assert got == want


def _state_tensors(state_np):
    tree = unflatten_paths({k: torch.from_numpy(v.copy())
                            for k, v in state_np.items()})
    opt = tree["opt"]
    return {"params": tree["params"],
            "opt": OptState(step=opt["step"], m=opt["m"], v=opt["v"])}


def _equal(restored, state_np, prefix=""):
    flat = flatten_with_paths(restored)
    assert sorted(flat) == sorted(state_np)
    for k, v in flat.items():
        assert np.array_equal(v.numpy(), state_np[k]), k


@pytest.mark.parametrize("shape,mode", [((2, 2), "resharded"),
                                        ((1, 1), "resharded"),
                                        ((4, 2), "identical")],
                         ids=["2x2", "1x1", "4x2"])
def test_port_restores_jax_image_onto_a_mesh(jax_side, shape, mode):
    model = _model()
    out = elastic_restore(jax_side["run"], _mesh(*shape), model,
                          AdamW(lr=constant(1e-3)))
    assert out["topology_mode"] == mode
    assert out["step"] == 3 and out["meta"]["cursor"] == {"step": 3}
    _equal({"params": out["params"], "opt": out["opt"]}, jax_side["state"])


@pytest.fixture(scope="module")
def port_image(jax_side):
    """The port's own (4, 2) image of the state JAX saved."""
    run = str(jax_side["dir"] / "port_run")
    mesh = _mesh(4, 2)
    state = _state_tensors(jax_side["state"])
    s = CheckpointSession(run, mesh=mesh)
    s.attach(lambda: {"train_state": state},
             {"train_state": state_shardings(_model(), mesh)})
    s.register_host_state("trainer", lambda: {"step": 3}, lambda st: None)
    s.register_host_state("data_cursor", lambda: {"step": 3},
                          lambda st: None)
    s.checkpoint(3)
    return run


def test_port_image_names_what_the_jax_image_names(jax_side, port_image):
    ours = SnapshotStore(port_image).reader(3)
    theirs = SnapshotStore(jax_side["run"]).reader(3)
    assert ours.manifest["topology"] == theirs.manifest["topology"]
    assert ours.state_names() == theirs.state_names()
    for st in theirs.state_names():
        assert sorted(ours.meta[st]) == sorted(theirs.meta[st])
        for path, m in theirs.meta[st].items():
            o = ours.meta[st][path]
            assert (o["kind"], o["shape"], o["dtype"], o["sharding"]) == \
                (m["kind"], m["shape"], m["dtype"], m["sharding"]), path
            assert sorted(map(str, o["shards"])) == \
                sorted(map(str, m["shards"])), path


def test_jax_restores_the_port_image_whole(jax_side, port_image):
    from repro.core import SnapshotEngine as JaxEngine
    eng = JaxEngine(port_image)
    eng.attach(lambda: {"train_state": None})
    restored = eng.restore()["train_state"]
    flat = {}
    for k, v in flatten_with_paths(restored).items():
        flat[k] = np.asarray(v)
    assert sorted(flat) == sorted(jax_side["state"])
    for k, v in flat.items():
        assert np.array_equal(v, jax_side["state"][k]), k


# ------------------------------------------------------ elastic trainer
def test_elastic_restore_of_the_port_trainer_steps_bitwise(tmp_path):
    cfg = get_smoke_config("qwen1.5-0.5b", **SMOKE)
    tcfg = TrainConfig(batch_size=4, seq_len=16, total_steps=8,
                       ckpt_every=3, compute_dtype=torch.float32,
                       remat=False, ckpt=CheckpointOptions(mode="sync"))
    run = str(tmp_path / "run")
    a = Trainer(cfg, tcfg, run, mesh=_mesh(4, 2))
    a.initialize()
    a.run(3)
    saved = {k: v.clone() for k, v in flatten_with_paths(
        {"params": a.params, "opt": a.opt_state}).items()}
    a.run(1)                                  # the uninterrupted step 4
    after = flatten_with_paths({"params": a.params, "opt": a.opt_state})
    reader = SnapshotStore(run).reader(3)
    assert reader.meta["train_state"]["params/embed/tok"]["sharding"][
        "spec"] == [["model"], ["data"]]
    for shape, mode in (((2, 2), "resharded"), ((1, 1), "resharded"),
                        ((4, 2), "identical")):
        mesh = _mesh(*shape) if shape != (1, 1) \
            else make_host_mesh(device="cpu")
        out = elastic_restore(run, mesh, _model(), AdamW(lr=constant(1e-3)),
                              step=3)
        assert out["topology_mode"] == mode and out["step"] == 3
        got = flatten_with_paths({"params": out["params"],
                                  "opt": out["opt"]})
        assert all(torch.equal(got[k], saved[k]) for k in saved)
        if mode == "identical":
            continue
        b = Trainer(cfg, tcfg, str(tmp_path / f"b{shape}"), mesh=mesh)
        b.params, b.opt_state, b.step = out["params"], out["opt"], 3
        b.pipeline.restore_state(out["meta"]["cursor"])
        b.run(1)
        nxt = flatten_with_paths({"params": b.params, "opt": b.opt_state})
        assert all(torch.equal(nxt[k], after[k]) for k in after), shape

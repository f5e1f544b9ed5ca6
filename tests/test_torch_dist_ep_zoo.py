"""The rest of the smoke zoo on a (2, 2) process mesh: four gloo ranks.

``tests/test_torch_dist_ep.py`` holds smoke qwen3-moe-30b-a3b and
qwen1.5-0.5b on ``make_host_mesh(data=2, model=2, group=...)``; this file
holds the other arches of the zoo there, against the JAX package on
``make_host_mesh(data=2, model=2)`` of 4 host devices: h2o-danube-1.8b
(the SWA ring under a ``kv_heads`` split), jamba-v0.1-52b (SSM heads and
``ssm_inner`` over ``model``, the expert-parallel MoE beside the SSM
layers of one super-block), whisper-tiny (the cross cache, written once
at prefill, heads over ``model``) and qwen2-vl-7b (vision rows and M-RoPE
positions that follow the data coordinate).  Policy ``baseline``, f32,
B 4 x 16 (qwen2-vl 4 x 24: its 16 vision rows, which the loss masks, and
8 text tokens), 3 steps from JAX's step-0 image; jamba at ``ssm_chunk=4`` in
both packages (at its smoke chunk of 8 the reference's grads are NaN:
tests/test_torch_dist_zoo.py, ROADMAP C).  For each arch:

  * training: the losses within rtol 1e-4 of JAX's (2, 2) run; every
    param and AdamW moment within twice the largest of 1e-4 of the
    leaf's max, the reference's own (2, 2)-vs-(1, 1) spread and the two
    packages' spread at one device, and within 1e-4 or twice the
    reference's spread of the port's own one-process run (the test's
    docstring says why); jamba's MoE aux loss, the mean over the ranks,
    within rtol 1e-4 of JAX's ``pmean``;
  * images: the port's (2, 2) step-3 image names JAX's entries with
    JAX's shapes, dtypes, specs and blocks, each distinct block written
    once, by the lowest rank that holds it; JAX's step-3 image restores
    in the port and the port's in JAX, bit-exact;
  * serving on (2, 2): JAX's (2, 2) server's tokens (whisper with its
    frames, qwen2-vl with its vision embeddings and image positions,
    danube with ``max_seq`` within its smoke window of 16: past it the
    JAX server's ring is wrong, ROADMAP C); the image taken
    mid-generation holds JAX's cache blocks, and a server of the port
    restores it cold at (2, 2) token-exact.

JAX runs in two subprocesses (jamba alone: its compile is the longest),
each restoring the port's image into JAX once the port has trained; the
port in two 4-rank launches beside them (jamba alone), each rank one
torch thread.  Every subprocess is bounded by TIMEOUT_S from its own
start.  Elastic restores across layouts and the (2, 1) repeat stay with
tests/test_torch_dist_ep.py's two arches: the mechanism does not depend
on the arch.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import assemble_global, flatten_with_paths
from repro_torch.core.snapshot_io import SnapshotStore
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.encdec import build_model
from repro_torch.sharding import state_shardings
from repro_torch.sharding.policy import index_to_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
JAMBA = "jamba-v0.1-52b"
ARCHS = ("h2o-danube-1.8b", JAMBA, "whisper-tiny", "qwen2-vl-7b")
#: the JAX subprocesses and the port's launches: jamba alone
GROUPS = ((JAMBA,), ("h2o-danube-1.8b", "whisper-tiny", "qwen2-vl-7b"))
#: config overrides of the smoke configs, in both packages: jamba's SSD
#: chunk at which the reference's grads stay finite
OVERRIDES = {JAMBA: {"ssm_chunk": 4}}
STEPS = 3
#: the training batch's sequence: 16, but qwen2-vl's 16 vision rows and 8
#: text tokens (at 16 its loss mask would drop every token)
SEQ = {"qwen2-vl-7b": 24}
#: serving: batch, decoded tokens, the snapshot's token; per arch the
#: prompt and the cache (danube: within its window of 16; qwen2-vl: a 4
#: x 4 image's 16 vision embeddings and 4 text tokens)
SB, TOKENS, AT = 4, 6, 3
SERVE = {"h2o-danube-1.8b": (8, 16), JAMBA: (8, 32), "whisper-tiny": (8, 32),
         "qwen2-vl-7b": (20, 32)}
#: per subprocess, from its own start: twice the longest that a run of
#: the tier-1 command measured (six xdist workers, --dist loadfile: the
#: fixture's subprocesses, all started at once, were done in 298 s; 125 s
#: with nothing beside them)
TIMEOUT_S = 600
#: the ranks' collective bound
BARRIER_S = 60.0

_COMMON = (f"STEPS, SB, TOKENS, AT = {STEPS}, {SB}, {TOKENS}, {AT}\n"
           f"SEQ = {SEQ!r}\n"
           f"SERVE, OVERRIDES = {SERVE!r}, {OVERRIDES!r}\n"
           f"DEADLINE_S = {TIMEOUT_S}\n") + textwrap.dedent("""
    import os as _os, time as _time


    def _wait(path, deadline_s=DEADLINE_S):
        t0 = _time.monotonic()
        while not _os.path.exists(path):
            if _time.monotonic() - t0 > deadline_s:
                raise TimeoutError(path)
            _time.sleep(0.1)
""")

# argv: the root, arches.  Per arch: the step-0 image ("start"), the
# serving weights and batch, "ready"; then the (2, 2) and (1, 1) runs
# (images at step 3, the (2, 2) run's aux losses), the (2, 2) server's
# tokens and its image, "jax_done"; then, once the port's (2, 2) image
# is there, JAX's restore of it.
_JAX = _COMMON + textwrap.dedent("""
    import os, pickle, shutil, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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
    from repro_torch.models.layers import image_positions

    root, archs = sys.argv[1], sys.argv[2:]
    pol = get_policy("baseline")

    def tcfg(arch):
        return TrainConfig(batch_size=4, seq_len=SEQ.get(arch, 16), lr=3e-4,
                           total_steps=STEPS, ckpt_every=STEPS,
                           ckpt=CheckpointOptions(mode="sync", keep=0),
                           seed=0, compute_dtype=jnp.float32)
    trainers = {}
    for arch in archs:
        cfg = get_smoke_config(arch, **OVERRIDES.get(arch, {}))
        d = os.path.join(root, arch)
        t = Trainer(cfg, tcfg(arch), make_host_mesh(data=2, model=2), pol,
                    os.path.join(d, "jax22"))
        t.initialize()
        t.session.checkpoint(0)
        shutil.copytree(os.path.join(d, "jax22"), os.path.join(d, "start"))
        trainers[arch] = t
        model = build_model(cfg, pol, make_host_mesh(data=2, model=2),
                            compute_dtype=jnp.float32, remat=False)
        rng = np.random.default_rng(0)
        params = jax.tree.map(
            lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
            model.init_abstract())
        with open(os.path.join(d, "params.pkl"), "wb") as f:
            pickle.dump(params, f)
        batch = TokenPipeline(cfg, SB, SERVE[arch][0], seed=0).next()
        if cfg.vision_stub:
            batch["positions"] = image_positions(
                SB, SERVE[arch][0], (4, 4)).numpy()
        np.savez(os.path.join(d, "batch.npz"), **batch)
        open(os.path.join(d, "ready"), "w").close()
    for arch in archs:
        cfg = get_smoke_config(arch, **OVERRIDES.get(arch, {}))
        d = os.path.join(root, arch)
        t, aux, step_fn = trainers[arch], [], trainers[arch]._step_fn

        def recorded(p, o, b, step_fn=step_fn, aux=aux):
            p, o, m = step_fn(p, o, b)
            aux.append(float(m["aux_loss"]) if "aux_loss" in m else 0.0)
            return p, o, m
        t._step_fn = recorded
        t.run(STEPS)
        one = Trainer(cfg, tcfg(arch), make_host_mesh(data=1, model=1), pol,
                      os.path.join(d, "jax11"))
        one.initialize()
        one.run(STEPS)
        mesh = make_host_mesh(data=2, model=2)
        model = build_model(cfg, pol, mesh, compute_dtype=jnp.float32,
                            remat=False)
        with open(os.path.join(d, "params.pkl"), "rb") as f:
            params = pickle.load(f)
        srv = DecodeServer(cfg, pol, mesh, os.path.join(d, "jax_serve"),
                           max_seq=SERVE[arch][1], model=model)
        srv.load(jax.device_put(params, model.param_shardings()))
        srv.start(dict(np.load(os.path.join(d, "batch.npz"))))
        srv.decode(AT)
        srv.checkpoint(0)
        srv.decode(TOKENS - AT)
        np.save(os.path.join(d, "jax_tokens.npy"), srv.tokens)
        # the reference's rule for the cache's layout (its server keeps
        # the layout its jitted prefill returns)
        with open(os.path.join(d, "cache_specs.json"), "w") as f:
            json.dump({k: [list(e) if isinstance(e, tuple) else e
                           for e in sh.spec]
                       for k, sh in flatten_with_paths(model.cache_shardings(
                           SB, SERVE[arch][1])).items()}, f)
        with open(os.path.join(d, "jax.json"), "w") as f:
            json.dump({"losses": t.metrics_history["loss"], "aux": aux}, f)
        open(os.path.join(d, "jax_done"), "w").close()
    for arch in archs:
        d = os.path.join(root, arch)
        _wait(os.path.join(d, "port_trained"))
        t = Trainer(get_smoke_config(arch, **OVERRIDES.get(arch, {})),
                    tcfg(arch), make_host_mesh(data=2, model=2), pol,
                    os.path.join(d, "p22"))
        assert t.restore() == STEPS
        np.savez(os.path.join(d, "jax_of_port.npz"), **{
            k: np.asarray(v) for k, v in flatten_with_paths(
                {"params": t.params, "opt": t.opt_state}).items()})
    print("JAX_OK")
""")

# argv: the root, arches.  The port's one-process run of each arch from
# JAX's step-0 image ("p11"): the packages' spread at one device.
_PORT11 = _COMMON + textwrap.dedent("""
    import shutil, sys
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    torch.set_num_threads(1)
    root, archs = sys.argv[1], sys.argv[2:]
    for arch in archs:
        d = _os.path.join(root, arch)
        _wait(_os.path.join(d, "ready"))
        shutil.copytree(_os.path.join(d, "start"), _os.path.join(d, "p11"))
        t = Trainer(get_smoke_config(arch, **OVERRIDES.get(arch, {})),
                    TrainConfig(batch_size=4, seq_len=SEQ.get(arch, 16),
                                lr=3e-4, total_steps=STEPS, ckpt_every=STEPS,
                                ckpt=CheckpointOptions(mode="sync", keep=0),
                                seed=0, compute_dtype=torch.float32),
                    _os.path.join(d, "p11"), device="cpu")
        assert t.restore() == 0
        t.run(STEPS)
    print("PORT11_OK")
""")

_RANKS = _COMMON + textwrap.dedent('''
    """Every rank's part, per arch: training at (2, 2) from JAX's step-0
    image, JAX's step-3 image restored on (2, 2); then serving at (2, 2)
    with a snapshot and a cold restore."""
    import json, os, pickle, shutil

    import numpy as np
    import torch

    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.encdec import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    from repro_torch.sharding import state_shardings
    from repro_torch.sharding.policy import index_to_json, rank_index


    def _train(cfg, arch, run, mesh, start):
        if mesh.rank == 0:
            shutil.copytree(start, run)
        mesh.group.all_ranks(True)
        t = Trainer(cfg, TrainConfig(
            batch_size=4, seq_len=SEQ.get(arch, 16), lr=3e-4,
            total_steps=STEPS,
            ckpt_every=STEPS, ckpt=CheckpointOptions(mode="sync", keep=0),
            seed=0, compute_dtype=torch.float32), run, mesh=mesh,
            device="cpu")
        assert t.restore() == 0
        aux, step = [], t._train_step

        def recorded(batch):
            m = step(batch)
            aux.append(float(m["aux_loss"]))
            return m
        t._train_step = recorded
        t.run(STEPS)
        out = {"losses": t.metrics_history["loss"], "aux": aux}
        t.release()
        return out


    def _blocks(cfg, run, mesh, out):
        """elastic_restore of `run` onto `mesh`: this rank's blocks and
        their indices, saved under `out`."""
        model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                            device="cpu")
        got = elastic_restore(run, mesh, model, AdamW(lr=constant(1e-3)))
        sh = flatten_with_paths(state_shardings(model, mesh))
        abstract = flatten_with_paths(
            {"params": model.init_abstract(),
             "opt": AdamW(lr=constant(1e-3)).init_abstract(
                 model.init_abstract())})
        blocks, index = {}, {}
        for k, t in flatten_with_paths({"params": got["params"],
                                        "opt": got["opt"]}).items():
            shape = tuple(abstract[k].shape)
            blocks[k] = t.numpy()
            index[k] = index_to_json(rank_index(sh[k], shape), shape)
        os.makedirs(out, exist_ok=True)
        np.savez(f"{out}/rank{mesh.rank}.npz", **blocks)
        with open(f"{out}/rank{mesh.rank}.json", "w") as f:
            json.dump({"index": index, "step": got["step"],
                       "ranks": mesh.size}, f)


    def _serve(cfg, arch, d, group):
        model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                            device="cpu")
        with open(f"{d}/params.pkl", "rb") as f:
            params = params_from_numpy(pickle.load(f), "cpu")
        batch = dict(np.load(f"{d}/batch.npz"))

        def server():
            return DecodeServer(cfg, f"{d}/serve", max_seq=SERVE[arch][1],
                                model=model, mesh=make_host_mesh(
                                    data=2, model=2, device="cpu",
                                    group=group))
        srv = server()
        srv.load(params)
        srv.start(batch)
        srv.decode(AT)
        srv.checkpoint(0)
        srv.decode(TOKENS - AT)
        got = {"plain": srv.tokens.tolist()}
        srv.release()
        cold = server()
        assert cold.restore() == SERVE[arch][0] + AT
        cold.decode(TOKENS - AT)
        got["cold"] = cold.tokens.tolist()
        cold.release()
        return got


    def main(argv, group):
        root, archs = argv[0], argv[1:]
        torch.manual_seed(0)
        report = {}
        for arch in archs:
            cfg = get_smoke_config(arch, **OVERRIDES.get(arch, {}))
            d = f"{root}/{arch}"
            _wait(f"{d}/ready")
            mesh22 = make_host_mesh(data=2, model=2, device="cpu",
                                    group=group)
            report[arch] = {"p22": _train(cfg, arch, f"{d}/p22", mesh22,
                                          f"{d}/start")}
            group.all_ranks(True)
            if group.rank == 0:
                open(f"{d}/port_trained", "w").close()
            _wait(f"{d}/jax_done")
            _blocks(cfg, f"{d}/jax22", mesh22, f"{d}/j22")
            report[arch]["serve"] = _serve(cfg, arch, d, group)
        reports = group.gather_objects(report)
        if group.rank == 0:
            with open(f"{root}/reports_{archs[0]}.json", "w") as f:
                json.dump(reports, f)
        return 0
''')


def _env(extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + (extra or [])))
    env.pop("XLA_FLAGS", None)
    return env


def _start(what, argv, env=None):
    """A started subprocess, with its own deadline: TIMEOUT_S from now."""
    proc = subprocess.Popen([sys.executable, *argv], env=env or _env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO)
    proc.what, proc.t0 = what, time.monotonic()
    proc.deadline = proc.t0 + TIMEOUT_S
    return proc


def _finish(proc):
    try:
        out, err = proc.communicate(
            timeout=max(proc.deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"timed out: {proc.what}\n{err[-3000:]}")
    print(f"{proc.what}: {time.monotonic() - proc.t0:.1f} s")   # -s
    assert proc.returncode == 0, f"{proc.what}\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both JAX subprocesses and both 4-rank launches at once; the ranks'
    reports (rank order, by arch) and the root."""
    root = tmp_path_factory.mktemp("dist_ep_zoo")
    (root / "ep_zoo_ranks.py").write_text(_RANKS)
    jax = [_start(f"JAX {' '.join(group)}", ["-c", _JAX, str(root), *group])
           for group in GROUPS]
    one = _start("port (1, 1)", ["-c", _PORT11, str(root), *ARCHS])
    port = []
    for group in GROUPS:
        code = ("import sys\nfrom repro_torch.launch import dist\n"
                f"sys.exit(dist.launch('ep_zoo_ranks:main', "
                f"{[str(root), *group]!r}, 4, 'cpu', "
                f"{str(root / group[0])!r}, {BARRIER_S!r}))")
        port.append(_start(f"port {' '.join(group)}", ["-c", code],
                           _env([str(root)])))
    for proc in port:
        _finish(proc)
    for proc in jax:
        assert "JAX_OK" in _finish(proc)
    assert "PORT11_OK" in _finish(one)
    reports = [{} for _ in range(4)]
    for group in GROUPS:
        with open(root / f"reports_{group[0]}.json") as f:
            for r, rep in enumerate(json.load(f)):
                reports[r].update(rep)
    return {"root": root, "reports": reports}


def _image(run, step=STEPS, state="train_state"):
    """(every device entry of `state`, assembled; the meta; the
    manifest)."""
    reader = SnapshotStore(str(run)).reader(step)
    try:
        meta = reader.meta[state]
        return ({k: assemble_global(reader.load_entry(state, k))
                 for k, m in meta.items() if m["kind"] == "device_array"},
                meta, reader.manifest)
    finally:
        reader.close()


def _spec(meta):
    """An entry's spec without its trailing replicated dims (JAX writes a
    replicated moment's spec as ``[]``, the port one None a dim)."""
    spec = [e[0] if isinstance(e, list) and len(e) == 1 else e
            for e in meta["sharding"]["spec"]]
    while spec and spec[-1] is None:
        spec.pop()
    return spec


def _same_layout(meta, jmeta):
    """The port's entries are JAX's, with JAX's shapes, dtypes, specs and
    blocks."""
    want = {k: m for k, m in jmeta.items() if m["kind"] == "device_array"}
    assert sorted(k for k, m in meta.items()
                  if m["kind"] == "device_array") == sorted(want)
    for k, m in want.items():
        o = meta[k]
        assert (o["shape"], o["dtype"]) == (m["shape"], m["dtype"]), k
        assert _spec(o) == _spec(m), (k, _spec(o), _spec(m))
        assert o["shards"] == m["shards"], k


@pytest.mark.parametrize("arch", ARCHS)
def test_four_ranks_train_the_zoo_to_the_jax_2x2_losses_and_leaves(runs,
                                                                   arch):
    """Every param and AdamW moment, by max |diff| / the leaf's max:

    * the port's (2, 2) run against JAX's (2, 2) within twice the largest
      of 1e-4, the reference's own (2, 2)-vs-(1, 1) spread and the
      packages' spread at one device (the port's one-process run against
      JAX's (1, 1)): the port is a third reduction order, and the
      packages already part at one device (a step's grads agree to 1e-4
      of each leaf's max, tests/test_torch_zoo.py and
      tests/test_torch_encdec.py; over 3 steps whisper's moments drift
      4.1e-4 apart, and qwen2-vl's key bias, whose elements take Adam's
      +-lr by a sign of rounding, 1.3e-2);
    * the port's (2, 2) run against its own one-process run within 1e-4,
      or twice the reference's own (2, 2)-vs-(1, 1) spread where that
      is larger: the layout moves the port no further than it moves the
      reference.

    ``-s`` prints each arch's worst leaf against each bound."""
    root = runs["root"] / arch
    rep = runs["reports"][0][arch]["p22"]
    with open(root / "jax.json") as f:
        want = json.load(f)
    assert len(want["losses"]) == STEPS and min(want["losses"]) > 0
    for r in runs["reports"]:                 # every rank logs the mean
        assert r[arch]["p22"]["losses"] == rep["losses"]
    np.testing.assert_allclose(rep["losses"], want["losses"], rtol=1e-4)
    ours, _, _ = _image(root / "p22")
    theirs, _, _ = _image(root / "jax22")
    one, _, _ = _image(root / "jax11")
    port_one, _, _ = _image(root / "p11")
    assert sorted(ours) == sorted(theirs) == sorted(port_one)
    bad, worst = {}, {"jax": (0.0, ""), "port": (0.0, "")}
    for k, t in theirs.items():
        scale = max(float(np.abs(t).max()), 1e-30)

        def dist(a, b):
            return float(np.abs(a - b).max()) / scale
        spread = dist(one[k], t)         # the reference's own, by layout
        bounds = {"jax": 2 * max(1e-4, spread, dist(port_one[k], one[k])),
                  "port": max(1e-4, 2 * spread)}
        got = {"jax": dist(ours[k], t), "port": dist(ours[k], port_one[k])}
        for side, bound in bounds.items():
            worst[side] = max(worst[side], (got[side] / bound, k))
            if got[side] > bound:
                bad[(side, k)] = (got[side], bound)
    for side, (ratio, k) in worst.items():
        print(f"{arch} against {side}'s: worst leaf {k} at {ratio:.3f} of "
              f"its bound")
    assert not bad, bad


def test_jamba_aux_loss_is_the_mean_over_ranks_of_the_jax_pmean(runs):
    with open(runs["root"] / JAMBA / "jax.json") as f:
        want = json.load(f)["aux"]
    got = [r[JAMBA]["p22"]["aux"] for r in runs["reports"]]
    assert len(want) == STEPS and [len(a) for a in got] == [STEPS] * 4
    assert min(want) > 0
    # the two ranks of a data coordinate route the same rows
    assert got[0] == got[1] and got[2] == got[3]
    np.testing.assert_allclose(np.mean(got, axis=0), want, rtol=1e-4)


def _lowest_ranks(arch, shapes):
    """{entry: {block index (JSON): the lowest rank of a (2, 2) mesh that
    holds it}}, by the train state's shardings at `shapes`."""
    model = build_model(get_smoke_config(arch, **OVERRIDES.get(arch, {})),
                        compute_dtype=torch.float32, remat=False,
                        device="cpu")
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    grid = mesh.devices.shape
    out = {}
    for k, sh in flatten_with_paths(state_shardings(model, mesh)).items():
        lowest = out[k] = {}
        for coord, idx in sorted(
                sh.devices_indices_map(shapes[k]).items(),
                key=lambda kv: np.ravel_multi_index(kv[0], grid)):
            lowest.setdefault(json.dumps(index_to_json(idx, shapes[k])),
                              int(np.ravel_multi_index(coord, grid)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_image_is_jax_layout_and_crosses_the_packages(runs, arch):
    root = runs["root"] / arch
    ours, meta, man = _image(root / "p22")
    theirs, jmeta, _ = _image(root / "jax22")
    _same_layout(meta, jmeta)
    # each distinct block once, in the pack of the lowest rank holding it
    assert man["num_hosts"] == 4
    lowest = _lowest_ranks(arch, {k: v.shape for k, v in ours.items()})
    for k in ours:
        shards = meta[k]["shards"]
        assert len(shards) == len(lowest[k]), k
        for i, idx in enumerate(shards):
            loc = man["locations"][f"train_state::{k}::s{i}"]
            r = lowest[k][json.dumps(idx)]
            assert loc.endswith(f"host{r:04d}.pack"), (k, i, loc)
    # JAX's step-3 image restored in the port, the port's in JAX
    placed = {k: np.zeros_like(v) for k, v in theirs.items()}
    seen = {k: np.zeros(v.shape, bool) for k, v in theirs.items()}
    for r in range(4):
        blocks = np.load(root / "j22" / f"rank{r}.npz")
        with open(root / "j22" / f"rank{r}.json") as f:
            info = json.load(f)
        assert info["step"] == STEPS and info["ranks"] == 4
        assert sorted(blocks.files) == sorted(theirs)
        for k in theirs:
            idx = tuple(slice(a, b) for a, b in info["index"][k])
            placed[k][idx] = blocks[k]
            seen[k][idx] = True
    for k, v in theirs.items():
        assert seen[k].all(), k
        assert np.array_equal(placed[k], v), k
    jax_of_port = np.load(root / "jax_of_port.npz")
    assert sorted(jax_of_port.files) == sorted(ours)
    for k, v in ours.items():
        assert jax_of_port[k].dtype == v.dtype, k
        assert np.array_equal(jax_of_port[k], v), k


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_serves_the_jax_tokens_and_resumes_cold(runs, arch):
    root = runs["root"] / arch
    want = np.load(root / "jax_tokens.npy")
    assert want.shape == (SB, SERVE[arch][0] + TOKENS + 1)
    for r in runs["reports"]:
        got = r[arch]["serve"]
        np.testing.assert_array_equal(np.asarray(got["plain"]), want)
        np.testing.assert_array_equal(np.asarray(got["cold"]), want)
    # the image taken mid-generation: JAX's entries, the params in JAX's
    # blocks, the cache in the reference's rule for it (JAX's server
    # keeps whatever layout its jitted prefill returns)
    _, meta, man = _image(root / "serve", 0, "serve_state")
    _, jmeta, _ = _image(root / "jax_serve", 0, "serve_state")
    assert man["num_hosts"] == 4
    assert sorted(meta) == sorted(jmeta)
    _same_layout({k: m for k, m in meta.items() if k.startswith("params/")},
                 {k: m for k, m in jmeta.items() if k.startswith("params/")})
    with open(root / "cache_specs.json") as f:
        rule = json.load(f)
    cache = {k: m for k, m in meta.items() if k.startswith("cache/")}
    assert sorted(k[len("cache/"):] for k in cache) == sorted(rule)
    for k, m in cache.items():
        assert (m["shape"], m["dtype"]) == (jmeta[k]["shape"],
                                            jmeta[k]["dtype"]), k
        assert _spec(m) == _spec({"sharding": {
            "spec": rule[k[len("cache/"):]]}}), (k, _spec(m))


def test_local_rows_take_mrope_positions_by_their_batch_dim():
    """A rank's rows of a VLM batch: M-RoPE ``positions`` (3, B, S) split
    over B, their second dim (the reference's ``(None, "batch",
    "seq")``), as every other entry over its first."""
    from repro_torch.data.pipeline import local_rows
    from repro_torch.models.layers import image_positions
    B, S = 4, 20
    pos = image_positions(B, S, (4, 4)).numpy()
    pos = pos + 100 * np.arange(B)[None, :, None]      # rows told apart
    batch = {"tokens": np.arange(B * S).reshape(B, S), "positions": pos,
             "vision_embeds": np.arange(B * 16 * 2.0).reshape(B, 16, 2)}
    for coord in (0, 1):
        got = local_rows(batch, coord, 2)
        rows = slice(2 * coord, 2 * coord + 2)
        np.testing.assert_array_equal(got["positions"], pos[:, rows])
        np.testing.assert_array_equal(got["tokens"], batch["tokens"][rows])
        np.testing.assert_array_equal(got["vision_embeds"],
                                      batch["vision_embeds"][rows])
    with pytest.raises(ValueError, match="3 rows"):
        local_rows({"tokens": np.zeros((3, S))}, 0, 2)

"""The model axis across processes: four gloo ranks on a (2, 2) mesh.

``make_host_mesh(data=2, model=2, group=...)`` lays four ranks out as the
reference lays four devices: the batch's rows over ``data`` (the two
ranks of a data coordinate take the same rows), the params' ``d_model``
dims over ``data`` and heads, ``d_ff``, vocab and experts over
``model``.  The MoE block is expert-parallel (``models/moe.py``): a rank
gathers its two of smoke qwen3-moe's four experts over ``data`` alone,
routes over all four, dispatches to its own and sums the partial
outputs over ``model``.  Held against the JAX package on ``(2, 2)`` of 4
host devices (one subprocess), smoke qwen3-moe-30b-a3b and smoke
qwen1.5-0.5b (tied embedding over ``vocab`` -> ``model``), f32, B 4 x 16,
3 steps from JAX's step-0 image:

  * the losses within rtol 1e-4 of JAX's (2, 2) run; every param and
    AdamW moment within 1e-4 of the leaf's max, or within the
    reference's own spread between its (2, 2) and (1, 1) runs where that
    is larger (as tests/test_torch_dist_zoo.py holds its leaves).  The
    key bias (``bk``: its param and both moments) has elements whose
    grads sit at the rounding floor (ROADMAP C: zero at init, each
    element's Adam step following the sign of rounding): the port's
    reduction order is a third one, held at twice that spread, and the
    test prints each such leaf's reading beside its bound (``-s``);
  * the rows follow the policy's data-parallel axes: under ``tp_wide``
    (``dp`` without ``data``) every rank trains on the whole batch, to
    JAX's (1, 1) losses; ``fsdp_all`` (``dp`` holding the experts'
    ``model`` axis) is refused for the MoE;
  * the (2, 2) run bitwise on a repeat, its losses within rtol 1e-5 of
    the port's own (2, 1) run (two of the ranks: each gradient is
    counted once) and its leaves within 1e-5 of their max, or within the
    reference's own (2, 2)-vs-(2, 1) spread where that is larger (the
    (2, 2) run sums the model ranks' shares of each attention, MLP and
    vocab block, and the clip's norm adds four partial sums where (2, 1)
    adds two; the key bias's rounding-floor elements carry that last bit
    on);
  * ``sharding.policy.GATHERED``: a step's peak is the top-level leaves
    plus one layer, with the layer's experts counted at ``E / |model|``
    and the leaves ``model`` cuts by heads, ``kv_heads``, ``d_ff`` and
    vocab at ``1 / |model|`` (a rank computes its own), the norms and
    the router whole;
  * the images: the port's (2, 2) image names JAX's entries with JAX's
    shapes, dtypes, specs and blocks, each distinct block written once,
    by the rank that holds its replica 0; JAX's step-3 image restores in
    the port and the port's in JAX, bit-exact; elastic restores (2, 2)
    -> (4, 1) and -> (1, 1) (a mesh of slots in this process), and
    (2, 1) -> (2, 2), bit-equal;
  * serving on (2, 2) (both archs): JAX's (2, 2) server's tokens; a
    rank keeps its rows' cache and its ``kv_heads`` block of it (its own
    heads' keys), and the image holds the policy's blocks (``kv_heads``
    over ``model``); a sync image taken mid-generation cold-restores
    token-exact at (2, 2) and at (4, 1).

A one-process unit test holds the EP body itself: the partial outputs
of two emulated model shards sum to the one-rank block within f32
rounding, each shard's slot table is the one-rank table's rows of its
experts bit for bit, with and without dropped tokens.

One JAX subprocess and one 4-rank launch (each rank one torch thread)
run beside each other; then a second JAX subprocess restores the port's
image.  Each is bounded by a timeout from its own start.
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

from repro_torch.core.device_plugin import assemble_global
from repro_torch.core.snapshot_io import SnapshotStore
from repro_torch.models import moe as MOE
from repro_torch.models.config import reduced
from repro_torch.configs import get_config, get_smoke_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCHS = ("qwen3-moe-30b-a3b", "qwen1.5-0.5b")
STEPS = 3
#: serving: batch, prompt, cache, tokens, the snapshot's token
SB, SS, MAX_SEQ, TOKENS, AT = 4, 8, 32, 6, 3
#: per subprocess, from its own start: under the tier-1 command (six
#: xdist workers, --dist loadfile) the 4-rank launch ran 143 s and the
#: JAX subprocesses 138 and 19 s; twice the longest
TIMEOUT_S = 300
BARRIER_S = 60.0

_COMMON = f"STEPS, SB, SS, MAX_SEQ, TOKENS, AT = {STEPS}, {SB}, {SS}, " \
          f"{MAX_SEQ}, {TOKENS}, {AT}\n"

# argv: the root, arches.  Writes each arch's step-0 image ("start"),
# the serving weights (params.pkl) and "ready" first; then the (2, 2),
# (1, 1) and (2, 1) runs (images at step 3), the (2, 2) server's tokens,
# and "jax_done".
_JAX = _COMMON + textwrap.dedent("""
    import os, pickle, shutil, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.api import CheckpointOptions
    from repro.configs import get_smoke_config
    from repro.data import TokenPipeline
    from repro.launch.mesh import make_host_mesh
    from repro.models.encdec import build_model
    from repro.runtime.server import DecodeServer
    from repro.runtime.trainer import TrainConfig, Trainer
    from repro.sharding import get_policy

    root, archs = sys.argv[1], sys.argv[2:]
    pol = get_policy("baseline")
    tcfg = TrainConfig(batch_size=4, seq_len=16, lr=3e-4, total_steps=STEPS,
                       ckpt_every=STEPS, ckpt=CheckpointOptions(mode="sync",
                                                                keep=0),
                       seed=0, compute_dtype=jnp.float32)
    trainers = {}
    for arch in archs:
        cfg, d = get_smoke_config(arch), os.path.join(root, arch)
        t = Trainer(cfg, tcfg, make_host_mesh(data=2, model=2), pol,
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
        open(os.path.join(d, "ready"), "w").close()
    for arch in archs:
        cfg, d = get_smoke_config(arch), os.path.join(root, arch)
        t = trainers[arch]
        t.run(STEPS)
        for data, model in ((1, 1), (2, 1)):
            other = Trainer(cfg, tcfg, make_host_mesh(data=data, model=model),
                            pol, os.path.join(d, f"jax{data}{model}"))
            other.initialize()
            other.run(STEPS)
            if data == 1:
                losses11 = other.metrics_history["loss"]
        mesh = make_host_mesh(data=2, model=2)
        model = build_model(cfg, pol, mesh, compute_dtype=jnp.float32,
                            remat=False)
        with open(os.path.join(d, "params.pkl"), "rb") as f:
            params = pickle.load(f)
        srv = DecodeServer(cfg, pol, mesh, os.path.join(d, "jax_serve"),
                           max_seq=MAX_SEQ, model=model)
        srv.load(jax.device_put(params, model.param_shardings()))
        srv.start(TokenPipeline(cfg, SB, SS, seed=0).next())
        srv.decode(TOKENS)
        np.save(os.path.join(d, "jax_tokens.npy"), srv.tokens)
        with open(os.path.join(d, "jax.json"), "w") as f:
            json.dump({"losses": t.metrics_history["loss"],
                       "losses11": losses11}, f)
        open(os.path.join(d, "jax_done"), "w").close()
    print("JAX_OK")
""")

# argv: the root, arches.  Restores the port's (2, 2) step-3 image into
# JAX's Trainer on (2, 2) and saves the restored leaves.
_JAX_RESTORE = _COMMON + textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax.numpy as jnp, numpy as np
    from repro.api import CheckpointOptions
    from repro.configs import get_smoke_config
    from repro.core.device_plugin import flatten_with_paths
    from repro.launch.mesh import make_host_mesh
    from repro.runtime.trainer import TrainConfig, Trainer
    from repro.sharding import get_policy

    root, archs = sys.argv[1], sys.argv[2:]
    tcfg = TrainConfig(batch_size=4, seq_len=16, total_steps=STEPS,
                       ckpt=CheckpointOptions(mode="sync", keep=0),
                       compute_dtype=jnp.float32)
    for arch in archs:
        d = os.path.join(root, arch)
        t = Trainer(get_smoke_config(arch), tcfg,
                    make_host_mesh(data=2, model=2), get_policy("baseline"),
                    os.path.join(d, "p22"))
        assert t.restore() == STEPS
        np.savez(os.path.join(d, "jax_of_port.npz"), **{
            k: np.asarray(v) for k, v in flatten_with_paths(
                {"params": t.params, "opt": t.opt_state}).items()})
    print("JAX_OK")
""")

_RANKS = _COMMON + textwrap.dedent('''
    """Every rank's part: training at (2, 2), its repeat, (2, 1) on
    ranks 0-1, the elastic restores, JAX's image in the port; then
    serving at (2, 2) with a snapshot and cold restores at (2, 2) and
    (4, 1)."""
    import json, os, pickle, shutil, time

    import numpy as np
    import torch

    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.encdec import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    from repro_torch.sharding import state_shardings
    from repro_torch.sharding.policy import (index_to_json, map_tree,
                                             rank_index)


    def _wait(path, deadline_s=150.0):
        t0 = time.monotonic()
        while not os.path.exists(path):
            if time.monotonic() - t0 > deadline_s:
                raise TimeoutError(path)
            time.sleep(0.1)


    def _expected(trainer, per_model):
        """Bytes a step gathers by arithmetic: every leaf a rank holds in
        blocks, whole, but an expert leaf at E / |model| experts and a
        leaf of heads, kv_heads, d_ff or vocab at 1 / |model| (the smoke
        configs' 4 / 2 heads, d_ff and vocab divide over 2), and not at
        all where the model axis alone cuts it (the qkv biases); the
        top-level leaves and one layer (a pattern of one)."""
        abstract = flatten_with_paths(trainer.model.init_abstract())
        shard = flatten_with_paths(trainer.shardings["params"])
        cut = flatten_with_paths(map_tree(
            lambda ax: int(any(a in ax for a in (
                "experts", "heads", "kv_heads", "d_ff", "vocab"))),
            trainer.model.param_axes()))
        cfg = trainer.cfg
        assert all(n % per_model == 0 for n in (
            cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.padded_vocab))
        top = layer = 0
        for k, a in abstract.items():
            shape = tuple(a.shape)
            if shard[k].shard_shape(shape) == shape:
                continue                  # every rank holds it whole
            n = a.numel() * a.element_size()
            if cut[k]:
                if {x for e in shard[k].spec if e
                        for x in ((e,) if isinstance(e, str) else e)} \
                        == {"model"}:
                    continue              # its own block: not gathered
                n //= per_model
            if k.startswith("blocks/"):
                layer += n // trainer.cfg.num_layers
            else:
                top += n
        return {"top": top, "layer": layer,
                "layers": layer * trainer.cfg.num_layers}


    def _tcfg():
        return TrainConfig(batch_size=4, seq_len=16, lr=3e-4,
                           total_steps=STEPS, ckpt_every=STEPS,
                           ckpt=CheckpointOptions(mode="sync", keep=0),
                           seed=0, compute_dtype=torch.float32)


    def _train(cfg, run, mesh, start, policy=None):
        if mesh.rank == 0:
            shutil.copytree(start, run)
        mesh.group.all_ranks(True)
        t = Trainer(cfg, _tcfg(), run, mesh=mesh, device="cpu",
                    policy=policy)
        assert t.restore() == 0
        t.run(STEPS)
        out = {"losses": t.metrics_history["loss"],
               "gathered": t.gathered,
               "expected": _expected(t, mesh.shape["model"])}
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


    def _serve(cfg, d, group):
        model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                            device="cpu")
        with open(f"{d}/params.pkl", "rb") as f:
            params = params_from_numpy(pickle.load(f), "cpu")
        run = f"{d}/serve"

        def server(data, model_axis):
            return DecodeServer(cfg, run, max_seq=MAX_SEQ, model=model,
                                mesh=make_host_mesh(
                                    data=data, model=model_axis,
                                    device="cpu", group=group))
        srv = server(2, 2)
        srv.load(params)
        srv.start(TokenPipeline(cfg, SB, SS, seed=0).next())
        srv.decode(AT)
        srv.checkpoint(0)
        srv.decode(TOKENS - AT)
        got = {"plain": srv.tokens.tolist(), "gathered": srv.gathered,
               "cache": {k: list(t.shape) for k, t in flatten_with_paths(
                   srv.cache).items()}}
        srv.release()
        for shape in ((2, 2), (4, 1)):
            cold = server(*shape)
            assert cold.restore() == SS + AT
            cold.decode(TOKENS - AT)
            got[f"cold{shape[0]}{shape[1]}"] = cold.tokens.tolist()
            cold.release()
        return got


    def main(argv, group):
        root, archs = argv[0], argv[1:]
        torch.manual_seed(0)
        report = {}
        for arch in archs:
            cfg, d = get_smoke_config(arch), f"{root}/{arch}"
            _wait(f"{d}/ready")
            rep = report[arch] = {}
            mesh22 = make_host_mesh(data=2, model=2, device="cpu",
                                    group=group)
            # the ranks that share a data coordinate, and a model one
            assert mesh22.axis_group(("model",)).ranks == tuple(
                2 * (group.rank // 2) + m for m in (0, 1))
            assert mesh22.axis_group(("data",)).ranks == tuple(
                group.rank % 2 + 2 * d for d in (0, 1))
            for tag in ("p22", "p22r"):
                rep[tag] = _train(cfg, f"{d}/{tag}", mesh22, f"{d}/start")
            # tp_wide's dp leaves data out: every rank takes every row
            rep["tp_wide"] = _train(cfg, f"{d}/tpw", mesh22, f"{d}/start",
                                    "tp_wide")
            if cfg.moe_num_experts:
                try:
                    Trainer(cfg, _tcfg(), f"{d}/fsdp_all", mesh=mesh22,
                            device="cpu", policy="fsdp_all")
                except ValueError as e:
                    rep["fsdp_all"] = str(e)
            sub = group.subgroup([0, 1])        # the ranks of data row 0
            if group.rank < 2:
                mesh21 = make_host_mesh(data=2, model=1, device="cpu",
                                        group=sub)
                rep["p21"] = _train(cfg, f"{d}/p21", mesh21, f"{d}/start")
            group.all_ranks(True)
            _blocks(cfg, f"{d}/p22", make_host_mesh(
                data=4, model=1, device="cpu", group=group), f"{d}/e22to41")
            mesh22 = make_host_mesh(data=2, model=2, device="cpu",
                                    group=group)
            _blocks(cfg, f"{d}/p21", mesh22, f"{d}/e21to22")
            _wait(f"{d}/jax_done")
            _blocks(cfg, f"{d}/jax22", mesh22, f"{d}/j22")
        for arch in archs:
            report[arch]["serve"] = _serve(get_smoke_config(arch),
                                           f"{root}/{arch}", group)
        reports = group.gather_objects(report)
        if group.rank == 0:
            with open(f"{root}/reports.json", "w") as f:
                json.dump(reports, f)
        return 0
''')


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
    try:
        out, err = proc.communicate(
            timeout=max(proc.deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"timed out: {proc.args}\n{err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs beside the 4 ranks', then JAX's restore of the port's
    image; the ranks' reports and the root."""
    root = tmp_path_factory.mktemp("dist_ep")
    (root / "ep_ranks.py").write_text(_RANKS)
    jax = _start(["-c", _JAX, str(root), *ARCHS])
    code = ("import sys\nfrom repro_torch.launch import dist\n"
            f"sys.exit(dist.launch('ep_ranks:main', "
            f"{[str(root), *ARCHS]!r}, 4, 'cpu', {str(root)!r}, "
            f"{BARRIER_S!r}))")
    port = _start(["-c", code], _env([str(root)]))
    assert "JAX_OK" in _finish(jax)
    _finish(port)
    assert "JAX_OK" in _finish(_start(["-c", _JAX_RESTORE, str(root),
                                       *ARCHS]))
    with open(root / "reports.json") as f:
        return {"root": root, "reports": json.load(f)}


def _image(run, step=STEPS):
    """(every device entry of train_state, assembled; the meta; the
    manifest's locations)."""
    reader = SnapshotStore(str(run)).reader(step)
    try:
        meta = reader.meta["train_state"]
        return ({k: assemble_global(reader.load_entry("train_state", k))
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


def _placed(out, ranks, saved):
    """The blocks each rank restored under `out`, placed at their
    indices: every leaf of `saved` covered."""
    placed = {k: np.zeros_like(v) for k, v in saved.items()}
    seen = {k: np.zeros(v.shape, bool) for k, v in saved.items()}
    for r in range(ranks):
        blocks = np.load(out / f"rank{r}.npz")
        with open(out / f"rank{r}.json") as f:
            info = json.load(f)
        assert info["step"] == STEPS and info["ranks"] == ranks
        assert sorted(blocks.files) == sorted(saved)
        for k in saved:
            idx = tuple(slice(a, b) for a, b in info["index"][k])
            placed[k][idx] = blocks[k]
            seen[k][idx] = True
    for k in saved:
        assert seen[k].all(), k
    return placed


@pytest.mark.parametrize("arch", ARCHS)
def test_four_ranks_train_to_the_jax_2x2_losses_and_leaves(runs, arch):
    root = runs["root"] / arch
    rep = runs["reports"][0][arch]
    with open(root / "jax.json") as f:
        want = json.load(f)["losses"]
    assert len(want) == STEPS
    np.testing.assert_allclose(rep["p22"]["losses"], want, rtol=1e-4)
    ours, _, _ = _image(root / "p22")
    theirs, _, _ = _image(root / "jax22")
    one, _, _ = _image(root / "jax11")
    assert sorted(ours) == sorted(theirs)
    bad = {}
    for k, t in theirs.items():
        scale = max(float(np.abs(t).max()), 1e-30)
        # the reference's own spread when its layout changes
        bound = max(1e-4, float(np.abs(one[k] - t).max()) / scale)
        got = float(np.abs(ours[k] - t).max()) / scale
        if k.endswith("/bk"):
            # the key bias's elements at the rounding floor (ROADMAP C):
            # the port is a third reduction order, up to the spread from
            # each of two
            bound *= 2
            print(f"{arch} {k}: {got:.4e} of its max, bound {bound:.4e}")
        if got > bound:
            bad[k] = (got, bound)
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_follow_the_policys_data_parallel_axes(runs, arch):
    with open(runs["root"] / arch / "jax.json") as f:
        want = json.load(f)["losses11"]
    for r in runs["reports"]:
        # tp_wide: dp = ("pod",), so every rank trains on the whole
        # batch, each token counted once over the four
        np.testing.assert_allclose(r[arch]["tp_wide"]["losses"], want,
                                   rtol=1e-4)
        if arch == ARCHS[0]:
            # fsdp_all: dp holds "model", which splits the experts
            assert "also split the batch" in r[arch]["fsdp_all"]


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_repeats_bitwise_and_matches_the_ports_2x1(runs, arch):
    reports = runs["reports"]
    rep = reports[0][arch]
    for r in reports:                       # every rank logs the mean
        assert r[arch]["p22"]["losses"] == rep["p22"]["losses"]
    assert rep["p22r"]["losses"] == rep["p22"]["losses"]
    np.testing.assert_allclose(rep["p22"]["losses"], rep["p21"]["losses"],
                               rtol=1e-5)
    root = runs["root"] / arch
    a, _, _ = _image(root / "p22")
    b, _, _ = _image(root / "p22r")
    c, _, _ = _image(root / "p21")
    j22, _, _ = _image(root / "jax22")
    j21, _, _ = _image(root / "jax21")
    for k, v in a.items():
        assert np.array_equal(v, b[k]), k
        # each leaf within 1e-5 of its max, or within the reference's own
        # spread between its (2, 2) and (2, 1) runs where that is larger
        scale = max(float(np.abs(v).max()), 1e-30)
        spread = float(np.abs(j22[k] - j21[k]).max()) / max(
            float(np.abs(j22[k]).max()), 1e-30)
        assert np.abs(v - c[k]).max() <= max(1e-5, spread) * scale, k


@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_peak_counts_a_ranks_own_experts(runs, arch):
    for r in runs["reports"]:
        rep = r[arch]["p22"]
        want, got = rep["expected"], rep["gathered"]
        assert want["top"] > 0 and want["layer"] > 0
        assert got["gathered_peak_bytes"] == want["top"] + want["layer"]
        # the forward's gathers and the backward's recompute's
        assert got["gathered_bytes"] == want["top"] + 2 * want["layers"]
    if arch == ARCHS[0]:
        # a rank's (2, 2) layer gathers half the experts its (2, 1) does
        rep = runs["reports"][0][arch]
        assert rep["p22"]["expected"]["layer"] < \
            rep["p21"]["expected"]["layer"]


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_image_is_jax_layout_and_crosses_the_packages(runs, arch):
    root = runs["root"] / arch
    ours, meta, man = _image(root / "p22")
    theirs, jmeta, _ = _image(root / "jax22")
    for k, m in jmeta.items():
        if m["kind"] != "device_array":
            continue
        o = meta[k]
        assert (o["shape"], o["dtype"]) == (m["shape"], m["dtype"]), k
        assert _spec(o) == _spec(m), k
        assert o["shards"] == m["shards"], k
    assert sorted(k for k, m in meta.items()
                  if m["kind"] == "device_array") == sorted(theirs)
    # each distinct block once, in the pack of its replica 0's rank
    assert man["num_hosts"] == 4
    router = [k for k in meta if k.endswith("/router")]
    for k in router + ["params/final_norm/scale"]:
        for i in range(len(meta[k]["shards"])):
            loc = man["locations"][f"train_state::{k}::s{i}"]
            assert loc.endswith("host0000.pack" if i == 0 else
                                "host0002.pack"), (k, i, loc)
    # JAX's step-3 image restored in the port, the port's in JAX
    placed = _placed(root / "j22", 4, theirs)
    for k, v in theirs.items():
        assert np.array_equal(placed[k], v), k
    jax_of_port = np.load(root / "jax_of_port.npz")
    for k, v in ours.items():
        assert np.array_equal(jax_of_port[k], v), k


@pytest.mark.parametrize("arch", ARCHS)
def test_elastic_restores_across_2x2_are_bit_equal(runs, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.encdec import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.elastic import elastic_restore

    root = runs["root"] / arch
    for src, out, ranks in (("p22", "e22to41", 4), ("p21", "e21to22", 4)):
        saved, _, _ = _image(root / src)
        placed = _placed(root / out, ranks, saved)
        for k, v in saved.items():
            assert np.array_equal(placed[k], v), (src, k)
    # (2, 2) -> (1, 1): one process
    saved, _, _ = _image(root / "p22")
    model = build_model(get_smoke_config(arch), compute_dtype=torch.float32,
                        remat=False, device="cpu")
    got = elastic_restore(str(root / "p22"), make_host_mesh(device="cpu"),
                          model, AdamW(lr=constant(1e-3)))
    flat = flatten_with_paths({"params": got["params"], "opt": got["opt"]})
    assert sorted(flat) == sorted(saved)
    for k, v in saved.items():
        assert np.array_equal(flat[k].numpy(), v), k


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_serves_the_jax_tokens_and_resumes_cold(runs, arch):
    root = runs["root"] / arch
    want = np.load(root / "jax_tokens.npy")
    assert want.shape == (SB, SS + TOKENS + 1)
    for r in runs["reports"]:
        got = r[arch]["serve"]
        np.testing.assert_array_equal(np.asarray(got["plain"]), want)
        np.testing.assert_array_equal(np.asarray(got["cold22"]), want)
        np.testing.assert_array_equal(np.asarray(got["cold41"]), want)
        # a rank's cache: its rows (over data), its half of the KV heads
        # (over model: those of its own heads)
        kv = get_smoke_config(arch).num_kv_heads
        for k, shape in got["cache"].items():
            assert shape[1] == SB // 2 and shape[3] == kv // 2, (k, shape)
    # the image: the policy's blocks, half the KV heads each
    reader = SnapshotStore(str(root / "serve")).reader(0)
    try:
        for k, m in reader.meta["serve_state"].items():
            if k.startswith("cache/"):
                spec = [e[0] if isinstance(e, list) else e
                        for e in m["sharding"]["spec"]]
                assert spec[1] == "data" and spec[3] == "model", (k, spec)
                assert len(m["shards"]) == 4, k
    finally:
        reader.close()


def _ep_setup(capacity_factor, T=24, E=4, k=2, d=16, f=32, seed=0):
    cfg = reduced(get_config("qwen3-moe-30b-a3b"), d_model=d,
                  moe_num_experts=E, moe_top_k=k, moe_d_ff=f,
                  moe_capacity_factor=capacity_factor)
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32))
    params = {"router": draw(d, E), "w_gate": draw(E, d, f),
              "w_up": draw(E, d, f), "w_down": draw(E, f, d)}
    return cfg, params, draw(T, d)


@pytest.mark.parametrize("capacity_factor,dropless", [(0.5, False),
                                                      (8.0, False),
                                                      (1.0, True)])
def test_ep_body_partials_sum_to_the_one_rank_block(capacity_factor,
                                                    dropless):
    cfg, params, x = _ep_setup(capacity_factor)
    E, k, T = cfg.moe_num_experts, cfg.moe_top_k, x.shape[0]
    y, aux = MOE.moe_block(params, cfg, x, dropless=dropless)
    _, top_w, top_e = MOE.route(x, params["router"], k)
    C = T if dropless else MOE.capacity(T, k, E, capacity_factor)
    whole = MOE.dispatch(top_e, top_w, E, C)
    if capacity_factor < 1:                 # some assignments dropped
        assert int(whole[2].sum()) < T * k
    parts, E_loc = [], E // 2
    for m in range(2):
        local = {n: (t[m * E_loc:(m + 1) * E_loc] if n != "router" else t)
                 for n, t in params.items()}
        tables = MOE.dispatch(top_e, top_w, E, C, m * E_loc, E_loc)
        for a, b in zip(tables, whole):
            assert torch.equal(a, b[m * E_loc:(m + 1) * E_loc])
        part, a_m = MOE.partial_moe(x, local, cfg, dropless, m * E_loc)
        assert part.dtype == torch.float32 and torch.equal(a_m, aux)
        parts.append(part)
    torch.testing.assert_close(parts[0] + parts[1], y, rtol=1e-6,
                               atol=1e-6)

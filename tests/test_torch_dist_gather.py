"""Per-layer param gathers across processes: two gloo ranks on the CPU.

Across ranks a rank holds only its ``d_model`` blocks of the params.  The
trainer runs the model on them under ``layers.gathering``: the model
gathers the top-level leaves once a step and each super-block's layers
inside its remat unit (``sharding.policy.GatherLeaves``: all-gather
forward, reduce-scatter backward), so the backward's recompute gathers
them again.  Held here, bitwise, against the step as it stood with one
whole copy of the params per rank, written below from ``gather_leaf``,
``loss_and_grads`` and ``scatter_grad``: every param leaf gathered whole
before the loss, the whole grads reduce-scattered after the backward.

  * smoke qwen1.5-0.5b (dense, tied embedding), smoke jamba-v0.1-52b at
    ``ssm_chunk=4`` and 16 layers (two passes over its pattern of 8 with
    MoE and Mamba layers) and smoke whisper-tiny (encoder and decoder):
    3 steps of each step from one init at 2 ranks, the losses, every
    param block and AdamW's m and v bitwise equal;
  * ``sharding.policy.GATHERED``: a per-layer step's peak of live
    gathered bytes is the top-level leaves plus the largest super-block
    (whisper: an encoder or a decoder layer), its bytes gathered the
    top-level leaves plus every layer twice (the forward and the
    recompute); the whole-gather step's peak is every gathered leaf;
  * the serve launcher at 2 ranks gives the tokens of one server in
    this process on the whole params (bitwise: the same SHA-256), each
    rank's gathered peak one layer plus the top-level leaves; one rank
    has no gather at all.

A leaf every rank holds whole (no ``d_model`` dim, e.g. a bias over the
heads) is not gathered and counts nowhere.  The existing
``tests/test_torch_dist*.py`` hold the same steps against the JAX
package's 2-device runs.  One launch of 2 ranks, each with one torch
thread, runs the three arches and then the serve launcher's rank, bounded
by a timeout.
"""
import hashlib
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.distributed import Group
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.encdec import build_model
from repro_torch.runtime.server import DecodeServer
from repro_torch.sharding import state_shardings
from repro_torch.sharding.policy import param_gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
#: arch -> its smoke config's overrides: jamba at the SSD chunk of the
#: zoo's parity runs (tests/test_torch_dist_zoo.py), and two passes over
#: its pattern of 8, so that one super-block is not the whole stack
ARCHS = {"qwen1.5-0.5b": {},
         "jamba-v0.1-52b": {"ssm_chunk": 4, "num_layers": 16},
         "whisper-tiny": {}}
STEPS = 3
TIMEOUT_S = 150
SERVE_ARCH, B, S, TOKENS, MAX_SEQ = "qwen1.5-0.5b", 4, 8, 6, 32
SERVE = ["--smoke", "--device", "cpu", "--arch", SERVE_ARCH, "--batch",
         str(B), "--prompt-len", str(S), "--tokens", str(TOKENS),
         "--max-seq", str(MAX_SEQ), "--dist-timeout", "30"]

_TARGET = textwrap.dedent('''
    """Both steps of the trainer at the group's ranks, from one init, for
    each arch; then the serve launcher's rank."""
    import json
    import types

    import torch

    from repro_torch.api import CheckpointOptions
    from repro_torch.launch import serve
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.trainer import (TrainConfig, Trainer,
                                             loss_and_grads)
    from repro_torch.sharding.policy import (GATHERED, gather_leaf,
                                             map_tree, scatter_grad)


    def whole_gather_step(self, batch):
        """The step with every param leaf gathered whole before the loss
        and the whole grads reduce-scattered after the backward."""
        shardings = self.shardings["params"]
        group = self.ranks.group
        ntok = {}

        def share(metrics):
            n = metrics["ntokens"].float()
            ntok["local"] = n.detach()
            ntok["global"] = group.all_reduce(n.detach().clone())
            return n.detach() / ntok["global"]

        GATHERED.begin()
        whole = map_tree(gather_leaf, self.params, shardings)
        metrics, grads = loss_and_grads(self.model, whole, batch,
                                        scale=share)
        del whole
        grads = map_tree(scatter_grad, grads, shardings)
        self.gathered = GATHERED.read()

        def grad_sq(g_flat):
            total = sum(torch.sum(torch.square(g.float()))
                        for k, g in g_flat.items() if self._primary[k])
            return group.all_reduce(torch.as_tensor(
                total, dtype=torch.float32, device=self.device))

        _, _, om = self.opt.update(grads, self.opt_state, self.params,
                                   grad_sq=grad_sq)
        metrics["loss"] = group.all_reduce(
            metrics["loss"] * ntok["local"]) / ntok["global"]
        metrics["ntokens"] = ntok["global"]
        return {**metrics, **om}


    def _expected(trainer):
        """Whole bytes of the gathered leaves (those a rank holds in
        blocks): the top-level leaves, each super-block (LM: one pass
        over the pattern; whisper: one encoder or decoder layer), and
        every layer."""
        abstract = flatten_with_paths(trainer.model.init_abstract())
        shard = flatten_with_paths(trainer.shardings["params"])
        cfg = trainer.cfg
        top, layers, units = 0, 0, {}
        for k, a in abstract.items():
            shape = tuple(a.shape)
            if shard[k].shard_shape(shape) == shape:
                continue                  # every rank holds it whole
            nbytes = a.numel() * a.element_size()
            head = k.split("/")[0]
            if head == "blocks":          # one layer of each pattern slot
                n_sb = cfg.num_layers // len(cfg.layer_pattern)
                units[head] = units.get(head, 0) + nbytes // n_sb
                layers += nbytes
            elif head in ("enc_blocks", "dec_blocks"):
                units[head] = units.get(head, 0) + nbytes // shape[0]
                layers += nbytes
            else:
                top += nbytes
        return {"top": top, "largest_unit": max(units.values()),
                "layers": layers}


    def both(out, arch, overrides, steps, group):
        """This rank's report of `arch`'s two steps (`out`: their run
        directories' prefix)."""
        cfg = get_smoke_config(arch, **overrides)
        mesh = make_host_mesh(data=group.world, model=1, device="cpu",
                              group=group)
        tcfg = TrainConfig(batch_size=4, seq_len=16, total_steps=int(steps),
                           ckpt_every=0,
                           ckpt=CheckpointOptions(mode="sync", keep=0),
                           seed=0, compute_dtype=torch.float32)
        got = {}
        for tag in ("layer", "whole"):
            t = Trainer(cfg, tcfg, f"{out}.{tag}", mesh=mesh,
                        policy="baseline", device="cpu")
            if tag == "whole":
                t._train_step_ranks = types.MethodType(whole_gather_step, t)
            t.initialize()
            t.run_until(int(steps))
            got[tag] = (t.metrics_history["loss"], flatten_with_paths({
                "params": t.params, "m": t.opt_state.m,
                "v": t.opt_state.v}), t.gathered)
            expected = _expected(t)
        differ = sorted(k for k, a in got["layer"][1].items()
                        if not torch.equal(a, got["whole"][1][k]))
        return {"losses": {k: v[0] for k, v in got.items()},
                "leaves": len(got["layer"][1]), "differ": differ,
                "gathered": {k: v[2] for k, v in got.items()},
                "expected": expected}


    def every_arch(argv, group):
        """argv: the output directory, the steps, {arch: the smoke
        config's overrides} (JSON), the serve launcher's arguments."""
        out, steps, archs, *serve_argv = argv
        reports = {arch: group.gather_objects(both(
            f"{out}/{arch}", arch, overrides, steps, group))
            for arch, overrides in json.loads(archs).items()}
        if group.rank == 0:
            with open(f"{out}/reports.json", "w") as f:
                json.dump(reports, f)
        return serve.rank_main(serve_argv, group)
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of 2 ranks: each arch's two steps, then the serve
    launcher; {arch: each rank's report, "serve": the serve JSON}."""
    root = tmp_path_factory.mktemp("gather")
    (root / "gather_ranks.py").write_text(_TARGET)
    argv = [str(root), str(STEPS), json.dumps(ARCHS), *SERVE,
            "--run-dir", str(root / "serve")]
    code = ("import sys\nfrom repro_torch.launch import dist\n"
            f"sys.exit(dist.launch('gather_ranks:every_arch', {argv!r}, "
            f"2, 'cpu', {str(root)!r}, 60.0))")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([SRC, str(root)]))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"timed out\n{err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    with open(root / "reports.json") as f:
        res = json.load(f)
    res["serve"] = json.loads(out[out.index("{\n"):])
    return res


@pytest.mark.parametrize("arch", list(ARCHS))
def test_per_layer_step_equals_the_whole_gather_step(runs, arch):
    for r in runs[arch]:
        assert len(r["losses"]["layer"]) == STEPS
        assert all(math.isfinite(x) for x in r["losses"]["layer"])
        # bitwise: the same floats, not within a tolerance
        assert r["losses"]["layer"] == r["losses"]["whole"]
        assert r["leaves"] > 0 and r["differ"] == [], r["differ"][:5]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_gathered_peak_is_top_level_plus_one_super_block(runs, arch):
    for r in runs[arch]:
        want = r["expected"]
        layer, whole = r["gathered"]["layer"], r["gathered"]["whole"]
        assert want["top"] > 0 and want["largest_unit"] > 0
        assert layer["gathered_peak_bytes"] == \
            want["top"] + want["largest_unit"]
        # the forward's gathers and the backward's recompute's
        assert layer["gathered_bytes"] == want["top"] + 2 * want["layers"]
        assert whole["gathered_peak_bytes"] == whole["gathered_bytes"] == \
            want["top"] + want["layers"]
        assert layer["gathered_peak_bytes"] < whole["gathered_peak_bytes"]


def test_two_rank_serve_gives_the_one_process_tokens(runs, tmp_path):
    two = runs["serve"]
    assert two["ranks"] == 2 and two["generated"] == TOKENS + 1
    cfg = get_smoke_config(SERVE_ARCH)
    model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                        device="cpu")
    srv = DecodeServer(cfg, str(tmp_path), max_seq=MAX_SEQ,
                       compute_dtype=torch.float32, model=model,
                       device="cpu")
    srv.load(model.init(0))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        srv.start(TokenPipeline(cfg, B, S, seed=0).next())
        srv.decode(TOKENS)
    finally:
        torch.set_num_threads(n)
    gen = np.ascontiguousarray(srv.tokens[:, S:], dtype=np.int32)
    # bitwise: the same tokens
    assert hashlib.sha256(gen.tobytes()).hexdigest() == \
        two["tokens_sha256"]
    # smoke qwen1.5 at 2 ranks: the tied embedding and the final norm,
    # and one layer, as the trainer's report at these ranks counts them
    want = runs[SERVE_ARCH][0]["expected"]
    for r in two["per_rank"]:
        assert r["gathered_peak_bytes"] == \
            want["top"] + want["largest_unit"]
        assert r["gathered_bytes"] == want["top"] + want["layers"]


def test_one_rank_has_nothing_to_gather():
    group = Group(0, 1, torch.device("cpu"), "gloo")   # no collective runs
    mesh = make_host_mesh(data=1, model=1, device="cpu", group=group)
    model = build_model(get_smoke_config(SERVE_ARCH), device="cpu")
    assert param_gather(state_shardings(model, mesh)["params"],
                        model.param_axes(), ("pod", "data")) is None

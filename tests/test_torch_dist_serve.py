"""The serve launcher across processes: two gloo ranks on the CPU.

``python -m repro_torch.launch.serve --nproc 2 --device cpu`` serves the
batch over ``data``: each rank prefills and decodes its rows against its
block of the KV cache (batch-sharded), the params' ``d_model`` blocks
gathered.  A snapshot taken mid-generation (``--snapshot-at``) and
resumed by a fresh 2-rank launcher (``--restore``) gives the tokens of the
uninterrupted run exactly; the image holds one pack per rank, each with
its rows of the cache.

Held against the reference: the JAX package's DecodeServer on
``make_host_mesh(data=2, model=1)`` (2 of 8 host devices, in a
subprocess) and 2 port ranks under ``launch.dist.launch`` serve the same
numpy weights and batch; each rank's server prefills and decodes its
rows against its block of the cache.  The tokens are equal, and the f32
prefill logits the servers compute agree within 1e-3, with each other
and with one port server in this process on the whole batch.  Each
subprocess is bounded by a timeout.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.snapshot_io import SnapshotStore
from repro_torch.data import TokenPipeline
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.encdec import build_model
from repro_torch.runtime.server import DecodeServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCH = "qwen1.5-0.5b"
B, S, MAX_SEQ, TOKENS, AT = 4, 8, 32, 6, 3
TIMEOUT_S = 120
BASE = ["--smoke", "--device", "cpu", "--nproc", "2", "--batch", str(B),
        "--prompt-len", str(S), "--tokens", str(TOKENS), "--max-seq",
        str(MAX_SEQ), "--dist-timeout", "20"]

_RANKS = textwrap.dedent('''
    """Each rank serves its rows of the batch with the weights in
    params.pkl and saves the prefill logits its server computes."""
    import pickle
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.encdec import build_model
    from repro_torch.runtime.server import DecodeServer

    def prefill_logits(argv, g):
        out, arch, b, s, max_seq, n = argv[0], argv[1], *map(int, argv[2:])
        cfg = get_smoke_config(arch)
        model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                            device="cpu")
        seen = []
        prefill = model.prefill

        def capture(params, inputs):           # the server's own call
            logits, cache = prefill(params, inputs)
            seen.append(logits.detach().clone())
            return logits, cache

        model.prefill = capture
        srv = DecodeServer(cfg, out + "/run", max_seq=max_seq,
                           model=model, device="cpu",
                           mesh=make_host_mesh(data=g.world, model=1,
                                               device="cpu", group=g))
        with open(f"{out}/params.pkl", "rb") as f:
            srv.load(params_from_numpy(pickle.load(f), "cpu"))
        srv.start(TokenPipeline(cfg, b, s, seed=0).next())
        srv.decode(n)
        np.save(f"{out}/logits{g.rank}.npy", seen[0].numpy())
        np.save(f"{out}/tokens{g.rank}.npy", srv.tokens)
        return 0
''')

_JAX_SERVE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke_config
    from repro.data import TokenPipeline
    from repro.launch.mesh import make_host_mesh
    from repro.models.encdec import build_model
    from repro.runtime.server import DecodeServer
    from repro.sharding import get_policy

    out, arch, b, s, max_seq, n = sys.argv[1], sys.argv[2], *map(
        int, sys.argv[3:])
    cfg, policy = get_smoke_config(arch), get_policy("baseline")
    mesh = make_host_mesh(data=2, model=1)
    model = build_model(cfg, policy, mesh, compute_dtype=jnp.float32,
                        remat=False)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        model.init_abstract())
    with open(os.path.join(out, "params.pkl"), "wb") as f:
        pickle.dump(params, f)
    srv = DecodeServer(cfg, policy, mesh, os.path.join(out, "jax_run"),
                       max_seq=max_seq, model=model)
    srv.load(jax.device_put(params, model.param_shardings()))
    seen = []
    prefill = srv._prefill

    def capture(p, inputs):
        logits, cache = prefill(p, inputs)
        seen.append(np.asarray(logits))
        return logits, cache

    srv._prefill = capture
    srv.start(TokenPipeline(cfg, b, s, seed=0).next())
    srv.decode(n)
    np.save(os.path.join(out, "jax_logits.npy"), seen[0])
    np.save(os.path.join(out, "jax_tokens.npy"), srv.tokens)
    print("JAX_OK")
""")


def _env(extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + (extra or [])))
    env.pop("XLA_FLAGS", None)
    return env


def _start(argv, env=None):
    return subprocess.Popen([sys.executable, *argv], env=env or _env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"timed out: {proc.args}\n{err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    return out


def _serve(*args):
    return _start(["-m", "repro_torch.launch.serve", *BASE, *args])


def _json(out):
    return json.loads(out[out.index("{\n"):])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_serve")
    (root / "dist_ranks.py").write_text(_RANKS)
    args = [str(root), ARCH, str(B), str(S), str(MAX_SEQ), str(TOKENS)]
    code = ("import sys\nfrom repro_torch.launch import dist\n"
            f"sys.exit(dist.launch('dist_ranks:prefill_logits', {args!r}, "
            f"2, 'cpu', {str(root)!r}, 20.0))")
    procs = {"plain": _serve("--run-dir", str(root / "a")),
             "snapshot": _serve("--run-dir", str(root / "b"),
                                "--snapshot-at", str(AT))}
    # the reference draws the weights (params.pkl) the port's ranks load
    res = {"jax": _finish(_start(["-c", _JAX_SERVE, *args]))}
    procs["logits"] = _start(["-c", code], _env([str(root)]))
    res.update({k: _finish(p) for k, p in procs.items()})
    res["restored"] = _finish(_serve("--run-dir", str(root / "b"),
                                     "--restore"))
    res["root"] = root
    return res


def test_two_ranks_resume_a_snapshot_token_exact(runs):
    ref, snap, got = (_json(runs[k])
                      for k in ("plain", "snapshot", "restored"))
    assert ref["ranks"] == 2 and ref["generated"] == TOKENS + 1
    assert f"serving snapshot at pos {S + AT}" in runs["snapshot"]
    assert f"restored mid-generation snapshot at pos {S + AT}" in \
        runs["restored"]
    assert snap["tokens_sha256"] == ref["tokens_sha256"]
    assert got["tokens_sha256"] == ref["tokens_sha256"]
    assert got["tokens_preview"] == ref["tokens_preview"]


def test_the_snapshot_holds_each_rank_rows_of_the_cache(runs):
    reader = SnapshotStore(str(runs["root"] / "b")).reader(0)
    try:
        man = reader.manifest
        assert man["num_hosts"] == 2
        cache = {p: m for p, m in reader.meta["serve_state"].items()
                 if p.startswith("cache/")}
        assert cache
        for path, m in cache.items():
            # (layers, batch, seq, kv, hd): batch over data, seq whole
            assert m["sharding"]["spec"][1] == ["data"], path
            assert [i[1] for i in m["shards"]] == [[0, B // 2], [B // 2, B]]
            for r in (0, 1):
                assert man["locations"][f"serve_state::{path}::s{r}"] \
                    .endswith(f"host000{r}.pack")
        assert reader.host_state()["decode_cursor"]["tokens"].shape[0] == B
    finally:
        reader.close()


def _two_ranks(root):
    """The 2-rank servers' prefill logits (rank order: the batch's rows)
    and each rank's tokens."""
    return (np.concatenate([np.load(root / f"logits{r}.npy")
                            for r in (0, 1)]),
            [np.load(root / f"tokens{r}.npy") for r in (0, 1)])


def test_two_ranks_serve_the_jax_tokens_and_logits(runs):
    assert "JAX_OK" in runs["jax"]
    root = runs["root"]
    logits, tokens = _two_ranks(root)
    want = np.load(root / "jax_logits.npy")
    assert logits.shape == want.shape == (B, want.shape[-1])
    np.testing.assert_allclose(logits, want, atol=1e-3, rtol=0)
    for got in tokens:              # every rank holds the whole generation
        assert got.shape == (B, S + TOKENS + 1)
        np.testing.assert_array_equal(got, np.load(root / "jax_tokens.npy"))


def test_two_rank_logits_match_one_server(runs):
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                        device="cpu")
    srv = DecodeServer(cfg, str(runs["root"] / "one"), max_seq=MAX_SEQ,
                       model=model, device="cpu")
    with open(runs["root"] / "params.pkl", "rb") as f:
        srv.load(params_from_numpy(pickle.load(f), "cpu"))
    batch = TokenPipeline(cfg, B, S, seed=0).next()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        logits, _ = model.prefill(srv.params, {"tokens": torch.as_tensor(
            batch["tokens"], dtype=torch.long)})
        srv.start(batch)
        srv.decode(TOKENS)
    finally:
        torch.set_num_threads(n)
    two, tokens = _two_ranks(runs["root"])
    np.testing.assert_allclose(two, logits.numpy(), atol=1e-3, rtol=0)
    for got in tokens:
        assert np.array_equal(got, srv.tokens)

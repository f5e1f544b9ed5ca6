"""Attention, the MLP and the vocab split over the ``model`` axis, on the CPU.

The reference's baseline policy puts ``heads``, ``kv_heads``, ``d_ff``
and ``vocab`` over ``model`` (``src/repro/sharding/policy.py``), and its
models pin q, k, v, the MLP's hidden and the logits to that split.  The
port computes the split by hand (``models/layers.py``): a rank's blocks
of the weights give its partial output, and the ranks' partials are
summed in f32.  One process emulates the ranks here, as
``chip_smoke.py``'s phase 1 does on the card, with the same functions:
``sharding.policy.rank_view`` cuts a rank's blocks from the whole params
by the port's block arithmetic, the model's ``_attn`` and
``layers.mlp`` give its partial, and the sum of the partials is held
against the JAX package's whole layer on the same numpy inputs, f32,
within 2e-5 of max |out| (``tests/test_kernels.py:14-16``):

  * attention at smoke widths over 2 and 4 ranks: the qkv bias
    (qwen1.5), the q/k-norm (qwen3-moe), M-RoPE (qwen2-vl) and the
    sliding window (danube, past its window);
  * a GQA group the split cuts: 12 query over 3 key heads at |model| 4
    (3 query heads a rank: two ranks take a slice of the key heads, two
    one key head per query head);
  * the MLP;
  * the parts that reduce across ranks mid-way -- the vocab-split
    embedding lookup, the cross-entropy over a padded vocab (loss and
    the logits' grads) and the greedy pick with a tie planted across
    two blocks -- run each emulated rank in a thread of its own over a
    group of threads;
  * a dim the axis does not divide stays whole: 6 heads over 4 ranks
    (whisper-tiny's), and a ``d_ff`` of 90;
  * the slice as a whole: a training step of the whole model (remat on)
    with every emulated rank in a thread, its loss weighted by its share
    over the ranks (as the trainer weights it), the ranks' grads of each
    split leaf laid side by side and of each whole leaf summed, against
    ``jax.grad`` of the JAX model within 1e-4 of each leaf's max
    (tests/test_torch_train.py's bound): each token's grad counted once,
    the tied embedding's two reads, the cut GQA group of 12 / 3 heads at
    |model| 4 included.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models.encdec import build_model as jax_build_model
from repro.sharding import get_policy
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM
from repro_torch.runtime.trainer import loss_and_grads
from repro_torch.sharding import get_policy as torch_policy
from repro_torch.sharding.policy import (TP_KINDS, Split, TensorShard,
                                         fit_sharding, leaf_gather_axes,
                                         map_tree, rank_view, tp_axes)

POLICY = get_policy("baseline")
#: the reference's f32 kernel tolerance, of max |out|
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(rng, *shape, scale=0.5):
    return rng.normal(0.0, scale, shape).astype(np.float32)


def _layer(cfg, seed=0):
    """One layer's attention and MLP params (numpy) of `cfg`."""
    rng = np.random.default_rng(seed)
    specs = {"attn": L.attention_specs(cfg)}
    if cfg.d_ff:
        specs["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff)
    out = {}
    for blk, leaves in specs.items():
        out[blk] = {}
        for k, spec in leaves.items():
            scale = 0.2 if spec.init == "zeros" else 1.0 / np.sqrt(
                spec.shape[0])
            out[blk][k] = _draw(rng, *spec.shape, scale=scale)
            if k.endswith("_norm"):
                out[blk][k] = 1.0 + out[blk][k]
    return out


def _axes(cfg):
    axes = {"attn": L.axes_tree(L.attention_specs(cfg))}
    if cfg.d_ff:
        axes["mlp"] = L.axes_tree(L.mlp_specs(cfg.d_model, cfg.d_ff))
    return axes


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _ranks(cfg, params, m):
    """Every rank's (TensorShard, its view of `params`) over ``model`` =
    `m` (a mesh of slots)."""
    mesh = make_host_mesh(data=1, model=m, device="cpu")
    return [rank_view(_torch(params), _axes(cfg), mesh, r, L.tp_units(cfg))
            for r in range(m)]


def _positions(cfg, B, S):
    if cfg.mrope:
        return L.image_positions(B, S, (2, 4)).numpy()
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


def _jax_attention(cfg, params, x, pos, window):
    """The JAX package's whole attention layer: q, k, v, attention, wo."""
    p = jax.tree.map(jnp.asarray, params["attn"])
    q, k, v = JL._qkv(p, cfg, jnp.asarray(x), jnp.asarray(pos), POLICY)
    o = JL.self_attention(q, k, v, causal=True, window=window)
    B, S = x.shape[:2]
    return np.asarray(o.reshape(B, S, -1) @ p["wo"])


def _close(got, want):
    err = float(np.abs(got - want).max())
    bound = TOL * float(np.abs(want).max())
    assert err <= bound, (err, bound)


def _attention_partials(cfg, params, m, x, pos):
    model = LM(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    parts = []
    for tp, local in _ranks(cfg, params, m):
        o, kv = model._attn_partial(local, 0, torch.from_numpy(x),
                                    torch.from_numpy(pos), tp=tp)
        parts.append((o, kv, tp))
    return model, parts


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b",
                                  "qwen2-vl-7b", "h2o-danube-1.8b"])
def test_attention_partials_sum_to_the_jax_layer(arch, m):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    assert cfg.qkv_bias or cfg.qk_norm or cfg.mrope or cfg.sliding_window
    B, S = 2, 24
    if cfg.sliding_window:
        assert S > cfg.sliding_window          # the window bites
    params = _layer(cfg)
    rng = np.random.default_rng(1)
    x = _draw(rng, B, S, cfg.d_model)
    pos = _positions(cfg, B, S)
    model, parts = _attention_partials(cfg, params, m, x, pos)
    cut = tp_axes(*_shardings(cfg, params, m), L.tp_units(cfg))
    assert cut["heads"] == ("model",)
    # key heads: 2 divide over 2 ranks, not over 4
    assert ("kv_heads" in cut) == (cfg.num_kv_heads % m == 0)
    for o, kv, tp in parts:
        assert kv["k"].shape[2] == cfg.num_kv_heads // (
            m if tp.kv_heads else 1)
    total = sum(o for o, _, _ in parts).numpy()
    _close(total, _jax_attention(jcfg, params, x, pos, model._window(0)))


def _shardings(cfg, params, m):
    """(the fitted shardings of `params` over model = `m`, the logical
    axes)."""
    mesh = make_host_mesh(data=1, model=m, device="cpu")
    pol = torch_policy("baseline").for_mesh(mesh)
    axes = _axes(cfg)
    return map_tree(lambda ax, t: fit_sharding(pol.sharding(mesh, *ax),
                                               t.shape), axes, params), axes


def test_a_gqa_group_cut_by_the_split_meets_its_key_heads():
    over = dict(num_heads=12, num_kv_heads=3)
    cfg = get_smoke_config("qwen1.5-0.5b", **over)
    jcfg = jax_smoke_config("qwen1.5-0.5b", **over)
    B, S, m = 2, 16, 4
    params = _layer(cfg)
    rng = np.random.default_rng(2)
    x = _draw(rng, B, S, cfg.d_model)
    pos = _positions(cfg, B, S)
    _, parts = _attention_partials(cfg, params, m, x, pos)
    rep = cfg.num_heads // cfg.num_kv_heads
    paired = []
    for o, kv, tp in parts:
        assert tp.heads.size == m and tp.kv_heads is None
        first, n = L.q_heads(cfg, tp)
        assert n == 3 and kv["k"].shape[2] == 3     # every key head
        k, _ = L.kv_for_heads(kv["k"], kv["v"], cfg, tp)
        want = kv["k"][:, :, torch.arange(first, first + n) // rep]
        if k.shape[2] < n:                          # a slice, GQA over it
            want = kv["k"][:, :, first // rep:(first + n - 1) // rep + 1]
        assert torch.equal(k, want)
        paired.append(k.shape[2])
    # ranks 0 and 3 hold a whole group's heads, 1 and 2 cut ones
    assert paired == [1, 3, 3, 1]
    _close(sum(o for o, _, _ in parts).numpy(),
           _jax_attention(jcfg, params, x, pos, 0))


@pytest.mark.parametrize("m", [2, 4])
def test_mlp_partials_sum_to_the_jax_mlp(m):
    cfg = get_smoke_config("phi3-medium-14b")
    params = _layer(cfg)
    rng = np.random.default_rng(3)
    x = _draw(rng, 2, 8, cfg.d_model)
    parts = [L.mlp(local["mlp"], torch.from_numpy(x))
             for tp, local in _ranks(cfg, params, m)]
    for (tp, local) in _ranks(cfg, params, m):
        assert tp.d_ff.size == m
        assert local["mlp"]["w_down"].shape[0] == cfg.d_ff // m
    want = JL.mlp(jax.tree.map(jnp.asarray, params["mlp"]), jnp.asarray(x),
                  POLICY)
    _close(sum(parts).numpy(), np.asarray(want))


def test_a_dim_the_axis_does_not_divide_stays_whole():
    # whisper-tiny's 6 heads over 4 ranks: wq's 384 columns divide, the
    # heads do not, so the attention is computed whole on every rank
    over = dict(num_heads=6, num_kv_heads=6, d_ff=90)
    cfg = get_smoke_config("qwen1.5-0.5b", **over)
    jcfg = jax_smoke_config("qwen1.5-0.5b", **over)
    params = _layer(cfg)
    shardings, axes = _shardings(cfg, params, 4)
    assert tuple(shardings["attn"]["wq"].spec)[1] == "model"
    assert tp_axes(shardings, axes, L.tp_units(cfg)) == {}
    for blk in ("attn", "mlp"):
        for k, sh in shardings[blk].items():
            assert leaf_gather_axes(sh, axes[blk][k], None) is None
    rng = np.random.default_rng(4)
    B, S = 2, 8
    x = _draw(rng, B, S, cfg.d_model)
    pos = _positions(cfg, B, S)
    _, parts = _attention_partials(cfg, params, 4, x, pos)
    want = _jax_attention(jcfg, params, x, pos, 0)
    for o, kv, tp in parts:
        assert tp is None and kv["k"].shape[2] == 6
        _close(o.numpy(), want)
    for tp, local in _ranks(cfg, params, 4):
        assert local["mlp"]["w_gate"].shape == (cfg.d_model, 90)


def test_an_emulated_rank_refuses_the_sum_over_ranks():
    # a rank_view split has no group: its partial output is not the
    # layer's, so every collective of the layers refuses it
    cfg = get_smoke_config("qwen1.5-0.5b")
    params = _layer(cfg)
    (tp, local), _ = _ranks(cfg, params, 2)
    assert tp.heads.group is None and tp.d_ff.group is None
    model = LM(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    x = torch.zeros(1, 4, cfg.d_model)
    pos = torch.from_numpy(_positions(cfg, 1, 4))
    with pytest.raises(ValueError, match="without a group"):
        model._attn(local, 0, x, pos, tp=tp)
    with pytest.raises(ValueError, match="without a group"):
        L.row_sum(L.mlp(local["mlp"], x), tp.d_ff)
    with pytest.raises(ValueError, match="without a group"):
        L.column_input(x, tp.d_ff, 2)


# ----------------------------------------------------------------------
# the parts that reduce across ranks mid-way: a rank per thread
# ----------------------------------------------------------------------
class _Threads:
    """The collectives of a group of `m` ranks that are threads of one
    process: each rank's tensor is shared, then reduced in rank order."""

    def __init__(self, m):
        self.m = m
        self._barrier = threading.Barrier(m, timeout=60)
        self._box = [None] * m

    def rank(self, r):
        return _ThreadRank(self, r)


class _ThreadRank:
    def __init__(self, threads, r):
        self.t, self.rank, self.world = threads, r, threads.m

    def _share(self, x):
        self.t._box[self.rank] = x.detach().clone()
        self.t._barrier.wait()
        parts = list(self.t._box)
        self.t._barrier.wait()
        return parts

    def all_gather(self, x):
        return self._share(x)

    def all_reduce(self, x, op="sum"):
        parts = self._share(x)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = acc + p if op == "sum" else torch.maximum(acc, p)
        return x.copy_(acc)


def _run_ranks(m, fn):
    """fn(rank, group) in a thread per rank; their results in rank order."""
    threads = _Threads(m)
    out, errs = [None] * m, []

    def body(r):
        try:
            out[r] = fn(r, threads.rank(r))
        except BaseException as e:              # noqa: BLE001
            errs.append(e)
            threads._barrier.abort()
    ts = [threading.Thread(target=body, args=(r,)) for r in range(m)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return out


def _vocab_split(m, r, group):
    return Split(("model",), group, r, m)


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_split_embedding_is_the_whole_lookup(m):
    cfg = get_smoke_config("qwen1.5-0.5b")
    rng = np.random.default_rng(5)
    table = torch.from_numpy(_draw(rng, cfg.padded_vocab, cfg.d_model))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    n = cfg.padded_vocab // m

    def rank(r, group):
        split = _vocab_split(m, r, group)
        return L.embed(table[r * n:(r + 1) * n], tokens, split,
                       torch.float32)
    want = L.embed(table, tokens, None, torch.float32)
    for got in _run_ranks(m, rank):
        assert torch.equal(got, want)


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_split_cross_entropy_over_a_padded_vocab(m):
    over = dict(vocab_size=500)
    cfg = get_smoke_config("phi3-medium-14b", **over)
    jcfg = jax_smoke_config("phi3-medium-14b", **over)
    assert cfg.padded_vocab == 512 > cfg.vocab_size
    rng = np.random.default_rng(6)
    B, S, d = 2, 10, cfg.d_model
    x = _draw(rng, B, S, d)
    w = _draw(rng, d, cfg.padded_vocab, scale=1.0)
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    n = cfg.padded_vocab // m

    def jax_loss(w):
        logits = JL.mask_padded_vocab(jnp.asarray(x) @ w, jcfg)
        return JL.softmax_xent_sharded(logits, jnp.asarray(targets),
                                       jnp.asarray(mask))[0]
    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(w))

    def rank(r, group):
        split = _vocab_split(m, r, group)
        wr = torch.from_numpy(w[:, r * n:(r + 1) * n].copy())
        wr.requires_grad_()
        logits = L.head({"lm_head": wr}, torch.from_numpy(x), cfg, split)
        loss, ntok = L.softmax_xent_sharded(
            logits, torch.from_numpy(targets).long(),
            torch.from_numpy(mask), split)
        # each rank's loss weighted by its share over the ranks of its
        # row, as the trainer weights it: the sum's backward counts each
        # token once
        (g,) = torch.autograd.grad(loss / m, [wr])
        return loss.detach(), g
    out = _run_ranks(m, rank)
    for loss, _ in out:
        assert abs(float(loss) - float(want)) <= TOL * abs(float(want))
    grad = torch.cat([g for _, g in out], dim=1).numpy()
    _close(grad, np.asarray(want_g))


def test_greedy_pick_takes_the_lowest_index_of_a_tie_across_blocks():
    cfg = get_smoke_config("qwen1.5-0.5b")
    m, V = 4, cfg.padded_vocab
    n = V // m
    rng = np.random.default_rng(7)
    logits = _draw(rng, 3, V)
    # row 0: a tie between block 1 and block 2; row 1: within block 3
    # and in block 0; row 2: no tie
    for row, cols in ((0, (n + 5, 2 * n + 1)), (1, (3, 3 * n + 2, 3 * n + 9))):
        logits[row, list(cols)] = logits[row].max() + 1.0
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    assert list(want[:2]) == [n + 5, 3]
    whole = torch.from_numpy(logits)
    assert L.greedy(whole).tolist() == want.tolist()

    def rank(r, group):
        return L.greedy(whole[:, r * n:(r + 1) * n],
                        _vocab_split(m, r, group))
    for got in _run_ranks(m, rank):
        assert got.dtype == torch.int32 and got.tolist() == want.tolist()


class _RankGather:
    """An emulated rank's gather: its params as they are (its blocks of
    the split leaves, every other leaf whole) and its TensorShard."""

    experts = None

    def __init__(self, tensor):
        self.tensor = tensor

    def __call__(self, tree, *path):
        return tree


@pytest.mark.parametrize("over,m", [({}, 2),
                                    (dict(num_heads=12, num_kv_heads=3), 4)])
def test_a_tensor_parallel_step_counts_each_tokens_grad_once(over, m):
    arch = "qwen1.5-0.5b"                     # tied embedding, qkv bias
    jm = jax_build_model(jax_smoke_config(arch, **over), POLICY, None,
                         compute_dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(8)
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        jm.init_abstract())
    cfg = get_smoke_config(arch, **over)
    toks = TokenPipeline(cfg, 2, 12, seed=1).next()["tokens"]
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {"tokens": jnp.asarray(toks, jnp.int32)})
    model = LM(cfg, compute_dtype=torch.float32, remat=True, device="cpu")
    whole = params_from_numpy(params, "cpu")
    logical = model.param_axes()
    mesh = make_host_mesh(data=1, model=m, device="cpu")
    batch = {"tokens": torch.as_tensor(toks).long()}

    def rank(r, group):
        tp, local = rank_view(whole, logical, mesh, r, L.tp_units(cfg))
        tp = TensorShard(**{k: Split(s.axes, group, s.index, s.size)
                            if s else None
                            for k in TP_KINDS for s in [getattr(tp, k)]})
        with L.gathering(_RankGather(tp)):
            met, grads = loss_and_grads(model, local, batch,
                                        scale=lambda _: torch.tensor(1 / m))
        return tp, float(met["loss"]), flatten_with_paths(grads)
    out = _run_ranks(m, rank)
    tp = out[0][0]
    assert tp.heads and tp.d_ff and tp.vocab
    assert (tp.kv_heads is None) == bool(over)
    for _, loss, _ in out:
        assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    # each leaf's dim that the ranks split, or -1: summed over the ranks
    dims = flatten_with_paths(map_tree(lambda ax: [next(
        (ax.index(k) for k in TP_KINDS if k in ax and getattr(tp, k)),
        -1)], logical))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        k = "/".join(str(p.key) for p in path)
        want = np.asarray(leaf)
        d = dims[k + "/0"]
        parts = [g[k] for _, _, g in out]
        got = (torch.cat(parts, dim=d) if d >= 0 else sum(parts)).numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= 1e-4 * scale, k

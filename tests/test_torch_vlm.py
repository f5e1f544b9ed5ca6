"""The port's VLM path (qwen2-vl-7b: M-RoPE, vision embeddings) held
against the JAX package's ``LM`` on the CPU.

Same numpy params, tokens, vision embeddings and 3-component positions
into both packages, f32, the smoke config (16 vision embeddings, hd 16):
``mrope_sections`` and M-RoPE itself against the reference's; the vision
embeddings replace the first P token embeddings and the positions' height
component moves the logits (ports of tests/test_models_smoke.py:160-190);
logits and loss to 1e-3, every grad leaf against ``jax.grad`` to 1e-4 of
its largest |g|; prefill + decode against ``forward`` (2e-4 / 5e-4) and
against the JAX prefill and decode, with positions laid out as a served
image prompt (the vision span at t = 0, h = row, w = col; text token i at
i in all three, the layout decode continues); more vision embeddings than
tokens raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import TokenPipeline as JaxPipeline
from repro.models import layers as JL
from repro.models.encdec import build_model as jax_build_model
from repro.sharding import get_policy
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.encdec import build_model
from repro_torch.runtime.trainer import loss_and_grads

ARCH = "qwen2-vl-7b"
POLICY = get_policy("baseline")
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke shapes run fastest on one thread (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models():
    jm = jax_build_model(jax_smoke_config(ARCH), POLICY, None,
                         compute_dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        jm.init_abstract())
    tm = build_model(get_smoke_config(ARCH), compute_dtype=torch.float32,
                     remat=False, device="cpu")
    return jm, jax.tree.map(jnp.asarray, params), tm, \
        params_from_numpy(params, "cpu")


def _batch(B=2, S=32, seed=1, positions=True):
    """tokens, vision_embeds (B, 16, 64) and the loss mask from the
    reference pipeline, with the positions of a 4 x 4 image."""
    batch = JaxPipeline(jax_smoke_config(ARCH), B, S, seed=seed).next()
    if positions:
        batch["positions"] = L.image_positions(B, S, (4, 4)).numpy()
    return batch


def test_image_positions_layout():
    pos = L.image_positions(2, 20, (4, 4))
    assert pos.shape == (3, 2, 20) and pos.dtype == torch.int32
    assert pos[0, :, :16].eq(0).all()
    assert pos[1, 0, :16].tolist() == [r for r in range(4) for _ in range(4)]
    assert pos[2, 0, :16].tolist() == list(range(4)) * 4
    assert pos[:, :, 16:].eq(torch.arange(16, 20, dtype=torch.int32)).all()
    with pytest.raises(ValueError, match="does not fit"):
        L.image_positions(1, 15, (4, 4))


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _paths(tree):
    return {"/".join(str(k.key) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("hd", [16, 64, 80, 128])
def test_mrope_sections_match_reference(hd):
    assert L.mrope_sections(hd) == JL.mrope_sections(hd)
    assert sum(L.mrope_sections(hd)) == hd // 2
    assert L.mrope_sections(128) == (16, 24, 24)


@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_matches_reference(hd):
    """Three components that differ everywhere: each frequency section
    turns by its own component."""
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 12, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 500, size=(3, 2, 12)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, mrope=True)
    got = L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                       mrope=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # equal components are plain RoPE
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    np.testing.assert_allclose(
        L.apply_rope(torch.as_tensor(x), torch.as_tensor(same), 1e6,
                     mrope=True).numpy(),
        L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[0]),
                     1e6).numpy(), rtol=1e-6, atol=1e-6)


def test_vision_embeds_override():
    """The vision embeddings stand in for the first P token embeddings:
    they move the logits, and the tokens under them do not."""
    _, _, tm, tp = _models()
    batch = _torch(_batch())
    P = batch["vision_embeds"].shape[1]
    with torch.no_grad():
        l1 = tm.forward(tp, batch)
        l2 = tm.forward(tp, dict(batch,
                                 vision_embeds=batch["vision_embeds"] + 1.0))
        toks = batch["tokens"].clone()
        toks[:, :P] = (toks[:, :P] + 7) % tm.cfg.vocab_size
        l3 = tm.forward(tp, dict(batch, tokens=toks))
    assert (l1 - l2).abs().max() > 1e-6
    assert torch.equal(l1, l3)


def test_mrope_positions_affect_logits():
    """The default positions are arange in all three components; moving
    the height component of the vision span moves the logits (moving it
    for every token alike would not: RoPE sees position differences).
    The model's own init: at the parity tests' small weights attention is
    near uniform and hardly sees positions."""
    _, _, tm, _ = _models()
    tp = tm.init(0)
    batch = _torch(_batch(positions=False))
    B, S = batch["tokens"].shape
    P = batch["vision_embeds"].shape[1]
    base = torch.arange(S, dtype=torch.int32).expand(3, B, S)
    shifted = base.clone()
    shifted[1, :, :P] += 7
    with torch.no_grad():
        l0 = tm.forward(tp, batch)    # default: arange in all three
        l1 = tm.forward(tp, dict(batch, positions=base))
        l2 = tm.forward(tp, dict(batch, positions=shifted))
    assert torch.equal(l0, l1)
    assert (l1 - l2).abs().max() > 1e-2


def test_forward_loss_and_grads_match_jax():
    jm, jp, tm, tp = _models()
    batch = _batch()
    V = tm.cfg.vocab_size
    lj = jm.forward(jp, _jax(batch))
    lt = tm.forward(tp, _torch(batch))
    np.testing.assert_allclose(lt.detach().numpy()[..., :V],
                               np.asarray(lj)[..., :V], **TOL)
    (jtot, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, _jax(batch))
    tmet, tgrads = loss_and_grads(tm, tp, _torch(batch))
    for name in ("loss", "ntokens"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   **TOL)
    want = {k: np.asarray(v) for k, v in _paths(jgrads).items()}
    got = {k: v.numpy() for k, v in flatten_with_paths(tgrads).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(got[k] - w).max() <= 1e-4 * scale, k


def test_prefill_decode_matches_forward_and_jax():
    jm, jp, tm, tp = _models()
    S, N = 24, 3
    batch = _batch(S=S + N, seed=3)
    full = tm.forward(tp, _torch(batch)).detach().numpy()
    prompt = dict(batch, tokens=batch["tokens"][:, :S],
                  positions=batch["positions"][:, :, :S])
    del prompt["loss_mask"]
    lt, ct = tm.prefill(tp, _torch(prompt))
    lj, cj = jm.prefill(jp, _jax(prompt))
    V = tm.cfg.vocab_size
    np.testing.assert_allclose(lt.numpy(), full[:, S - 1], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(lt.numpy()[:, :V], np.asarray(lj)[:, :V],
                               **TOL)
    for k, w in _paths(cj).items():
        np.testing.assert_allclose(flatten_with_paths(ct)[k].numpy(),
                                   np.asarray(w), **TOL, err_msg=k)
    pad = [(0, 0), (0, 0), (0, N), (0, 0), (0, 0)]
    ct = {"pos0": {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, N))
                   for k, v in ct["pos0"].items()}}
    cj = {"pos0": {k: jnp.pad(v, pad) for k, v in cj["pos0"].items()}}
    for i in range(N):
        tok = batch["tokens"][:, S + i]
        ld, ct = tm.decode_step(tp, ct, torch.as_tensor(tok).long(), S + i)
        ljd, cj = jm.decode_step(jp, cj, jnp.asarray(tok), jnp.int32(S + i))
        np.testing.assert_allclose(ld.numpy(), full[:, S + i], rtol=5e-4,
                                   atol=5e-4, err_msg=str(i))
        np.testing.assert_allclose(ld.numpy()[:, :V],
                                   np.asarray(ljd)[:, :V], **TOL)


def test_more_vision_embeds_than_tokens_raise():
    _, _, tm, tp = _models()
    batch = _torch(_batch(S=12, positions=False))   # 16 embeddings
    with pytest.raises(ValueError, match="do not fit"):
        tm.forward(tp, batch)
    with pytest.raises(ValueError, match="do not fit"):
        tm.prefill(tp, batch)

"""The port's encoder-decoder (whisper-tiny) held against the JAX
package's ``EncDecLM`` on the CPU.

Same numpy params (``params_from_numpy``), tokens and frames into both
packages, f32, the smoke config (2 encoder + 2 decoder layers, 32
frames): the param and cache trees name the reference's entries; logits
and loss to 1e-3 (tests/test_models_smoke.py); every grad leaf against
``jax.grad`` to 1e-4 of that leaf's largest |g| (as
tests/test_torch_zoo.py); prefill + decode against ``forward`` (2e-4,
5e-4 along a decode chain, tests/test_models_smoke.py:75-143) and
against the JAX prefill, caches and decode step; the frames reach the
decoder (tests/test_models_smoke.py:193-204); the kernel path (on the
CPU the kernels' plain versions) equals the plain path; remat equals no
remat bit for bit; and ``build_model`` picks the class from the config.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import TokenPipeline as JaxPipeline
from repro.models.encdec import build_model as jax_build_model
from repro.sharding import get_policy
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.encdec import EncDecLM, build_model
from repro_torch.models.lm import LM
from repro_torch.runtime.trainer import loss_and_grads

ARCH = "whisper-tiny"
POLICY = get_policy("baseline")
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke shapes run fastest on one thread (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(**kw):
    """The JAX and the port's EncDecLM (f32, no remat) and the same numpy
    params for both."""
    jm = jax_build_model(jax_smoke_config(ARCH), POLICY, None,
                         compute_dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        jm.init_abstract())
    tm = build_model(get_smoke_config(ARCH), compute_dtype=torch.float32,
                     remat=False, device="cpu", **kw)
    return jm, jax.tree.map(jnp.asarray, params), tm, \
        params_from_numpy(params, "cpu")


def _batch(B=2, S=32, seed=1):
    """numpy tokens and frames (B, 32, 64) from the reference pipeline."""
    return JaxPipeline(jax_smoke_config(ARCH), B, S, seed=seed).next()


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _paths(tree):
    return {"/".join(str(k.key) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_build_model_picks_the_class():
    assert isinstance(build_model(get_smoke_config(ARCH), device="cpu"),
                      EncDecLM)
    assert isinstance(build_model(get_smoke_config("qwen2-vl-7b"),
                                  device="cpu"), LM)
    with pytest.raises(ValueError, match="no encoder layers"):
        EncDecLM(get_smoke_config("qwen1.5-0.5b"), device="cpu")


def test_param_and_cache_trees_match_reference():
    jm, _, tm, _ = _models()
    jflat = {k: v.shape for k, v in _paths(jm.init_abstract()).items()}
    tflat = {k: tuple(v.shape)
             for k, v in flatten_with_paths(tm.init_abstract()).items()}
    assert tflat == jflat
    jc = {k: (v.shape, str(v.dtype)) for k, v in
          _paths(jm.cache_abstract(3, 40)).items()}
    tc = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in
          flatten_with_paths(tm.cache_abstract(3, 40)).items()}
    assert tc == jc
    assert set(tc) == {"self_k", "self_v", "cross_k", "cross_v"}


def test_forward_and_loss_match_jax():
    jm, jp, tm, tp = _models()
    batch = _batch()
    V = tm.cfg.vocab_size
    lj = jm.forward(jp, _jax(batch))
    lt = tm.forward(tp, _torch(batch))
    assert lt.shape == (2, 32, tm.cfg.padded_vocab)
    np.testing.assert_allclose(lt.detach().numpy()[..., :V],
                               np.asarray(lj)[..., :V], **TOL)
    jtot, jmet = jm.loss(jp, _jax(batch))
    ttot, tmet = tm.loss(tp, _torch(batch))
    np.testing.assert_allclose(float(ttot), float(jtot), **TOL)
    for name in ("loss", "aux_loss", "ntokens"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   **TOL)
    assert float(tmet["aux_loss"]) == 0.0


def test_grads_match_jax():
    jm, jp, tm, tp = _models()
    batch = _batch()
    (_, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, _jax(batch))
    tmet, tgrads = loss_and_grads(tm, tp, _torch(batch))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               **TOL)
    want = {k: np.asarray(v) for k, v in _paths(jgrads).items()}
    got = {k: v.numpy() for k, v in flatten_with_paths(tgrads).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(got[k] - w).max() <= 1e-4 * scale, k
    # the loss reaches the encoder through the cross-attention
    assert np.abs(got["enc_blocks/attn/wq"]).max() > 0


def test_prefill_decode_matches_forward_and_jax():
    """prefill(prompt) + a chain of decode steps agree with a full
    forward over prompt + tokens, and with the JAX prefill (logits and
    every cache leaf) and decode steps."""
    jm, jp, tm, tp = _models()
    S, N = 24, 4
    batch = _batch(S=S + N, seed=3)
    full = tm.forward(tp, _torch(batch)).detach().numpy()
    prompt = dict(batch, tokens=batch["tokens"][:, :S])
    lt, ct = tm.prefill(tp, _torch(prompt))
    lj, cj = jm.prefill(jp, _jax(prompt))
    V = tm.cfg.vocab_size
    np.testing.assert_allclose(lt.numpy(), full[:, S - 1], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(lt.numpy()[:, :V], np.asarray(lj)[:, :V],
                               **TOL)
    assert ct["cross_k"].shape[2] == tm.cfg.num_audio_frames
    for k, w in _paths(cj).items():
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(w), **TOL,
                                   err_msg=k)
    ct = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, N))
          if k.startswith("self") else v for k, v in ct.items()}
    cj = {k: jnp.pad(v, [(0, 0), (0, 0), (0, N), (0, 0), (0, 0)])
          if k.startswith("self") else v for k, v in cj.items()}
    for i in range(N):
        tok = batch["tokens"][:, S + i]
        ld, ct = tm.decode_step(tp, ct, torch.as_tensor(tok).long(), S + i)
        ljd, cj = jm.decode_step(jp, cj, jnp.asarray(tok), jnp.int32(S + i))
        np.testing.assert_allclose(ld.numpy(), full[:, S + i], rtol=5e-4,
                                   atol=5e-4, err_msg=str(i))
        np.testing.assert_allclose(ld.numpy()[:, :V],
                                   np.asarray(ljd)[:, :V], **TOL)
    with pytest.raises(ValueError, match="outside the cache"):
        tm.decode_step(tp, ct, torch.as_tensor(tok).long(), S + N)


def test_frames_affect_decoder():
    """tests/test_models_smoke.py:193-204 in the port."""
    _, _, tm, tp = _models()
    batch = _torch(_batch())
    with torch.no_grad():
        l1 = tm.forward(tp, batch)
        l2 = tm.forward(tp, dict(batch, frames=batch["frames"] * 2.0 + 0.5))
    assert (l1 - l2).abs().max() > 1e-6


def test_use_kernels_equals_plain_path():
    _, _, m0, tp = _models()
    _, _, m1, _ = _models(use_kernels=True)
    batch = _torch(_batch())
    V = m0.cfg.vocab_size
    with torch.no_grad():
        torch.testing.assert_close(m1.forward(tp, batch)[..., :V],
                                   m0.forward(tp, batch)[..., :V], **TOL)
        l0, c0 = m0.prefill(tp, batch)
        l1, c1 = m1.prefill(tp, batch)
    torch.testing.assert_close(l1, l0, **TOL)
    torch.testing.assert_close(c1, c0, **TOL)


def test_remat_equals_no_remat_bitwise():
    _, _, _, tp = _models()
    batch = _torch(_batch())
    out = [loss_and_grads(
        build_model(get_smoke_config(ARCH), remat=remat,
                    compute_dtype=torch.float32, device="cpu"), tp, batch)
        for remat in (False, True)]
    assert torch.equal(out[0][0]["loss"], out[1][0]["loss"])
    a, b = (flatten_with_paths(o[1]) for o in out)
    for k in a:
        assert torch.equal(a[k], b[k]), k

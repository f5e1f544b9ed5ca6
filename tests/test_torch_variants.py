"""The dry run's variant knobs in the port, held against the reference.

Port of tests/test_perf_variants.py: every knob changes the layout or the
traffic, never the function beyond dtype rounding.  ``GQA_EXPAND`` is
exact, ``XENT_SEQ_CHUNK`` bitwise, the rolled-target loss equals the
sliced one, bf16 scores and ``CAST_PARAMS_ONCE`` stay close to the f32 /
master path, and ``apply_variant`` sets and composes the port's knobs.
Then each knob against the reference: the same numpy params and tokens
into both packages with the knob set in each, the port's logits (or
loss) to the reference's within a few bf16 ulps (bf16 knobs) or at f32
parity.  The ``seq_par`` and ``fsdp_all`` specs equal the reference's.
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
from repro.sharding import get_policy as jax_policy
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import apply_variant, variant_parts
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM
from repro_torch.sharding import get_policy

POLICY = jax_policy("baseline")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke shapes run fastest on one thread (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reset_knobs():
    yield
    apply_variant("base")
    JL.SCORE_DTYPE = jnp.float32
    JL.XENT_SEQ_CHUNK = 0
    JL.GQA_EXPAND = False
    JL.CAST_PARAMS_ONCE = False


def _models(arch="qwen1.5-0.5b", B=2, S=32, dtype="f32"):
    """The reference's and the port's LM (no remat) at `dtype` compute,
    the same numpy params and the same batch for both."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jm = jax_build_model(jax_smoke_config(arch), POLICY, None,
                         compute_dtype=jdt, remat=False)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        jm.init_abstract())
    tm = LM(get_smoke_config(arch), compute_dtype=tdt, remat=False,
            device="cpu")
    tokens = JaxPipeline(jax_smoke_config(arch), B, S,
                         seed=1).next()["tokens"].astype(np.int32)
    return (jm, jax.tree.map(jnp.asarray, params), {"tokens": tokens},
            tm, params_from_numpy(params, "cpu"),
            {"tokens": torch.from_numpy(tokens).long()})


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------- ports of the tests
def test_gqa_expand_is_exact():
    *_, tm, tp, tb = _models("phi3-medium-14b")
    assert tm.cfg.num_kv_heads < tm.cfg.num_heads      # GQA smoke (2 of 4)
    l0 = tm.forward(tp, tb)
    L.GQA_EXPAND = True
    np.testing.assert_allclose(_np(tm.forward(tp, tb)), _np(l0),
                               rtol=1e-5, atol=1e-5)


def test_xent_chunking_is_exact():
    *_, tm, tp, tb = _models()
    loss0 = tm.loss(tp, tb)[1]["loss"]
    L.XENT_SEQ_CHUNK = 8
    assert torch.equal(tm.loss(tp, tb)[1]["loss"], loss0)


def test_rolled_loss_equals_sliced_loss():
    *_, tm, tp, tb = _models()
    logits = tm.forward(tp, tb)[:, :-1].float()
    tok = tb["tokens"]
    sliced = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tok[:, 1:].reshape(-1))
    assert abs(float(sliced) - float(tm.loss(tp, tb)[1]["loss"])) < 1e-6


def test_bf16_scores_close_to_f32():
    *_, tm, tp, tb = _models()
    V = tm.cfg.vocab_size
    l0 = tm.forward(tp, tb)
    L.SCORE_DTYPE = torch.bfloat16
    np.testing.assert_allclose(_np(tm.forward(tp, tb))[..., :V],
                               _np(l0)[..., :V], rtol=0.1, atol=0.2)


def test_cast_params_once_close_to_master():
    *_, tp, tb = _models()[3:]
    tm = LM(get_smoke_config("qwen1.5-0.5b"), compute_dtype=torch.bfloat16,
            remat=False, device="cpu")
    V = tm.cfg.vocab_size
    l_base = tm.forward(tp, tb)
    L.CAST_PARAMS_ONCE = True
    l_cast = tm.forward(tp, tb)
    np.testing.assert_allclose(_np(l_cast)[..., :V], _np(l_base)[..., :V],
                               rtol=0.1, atol=0.3)
    # and the grads still reach the f32 masters
    flat = {"w": tp["blocks"]["pos0"]["attn"]["wq"].clone()
            .requires_grad_()}
    tp["blocks"]["pos0"]["attn"]["wq"] = flat["w"]
    tm.loss(tp, tb)[0].backward()
    assert flat["w"].grad is not None and flat["w"].grad.dtype == \
        torch.float32


def test_apply_variant_sets_and_composes():
    assert variant_parts("gqaexpand_bf16cast") == {"gqaexpand", "bf16cast"}
    assert variant_parts("opt") == {"gqaexpand", "bf16cast", "gradbf16",
                                    "xentchunk"}
    with pytest.raises(ValueError, match="unknown variant"):
        variant_parts("gqaexpand_nope")
    assert apply_variant("gqaexpand_bf16score") is True
    assert L.GQA_EXPAND and L.SCORE_DTYPE == torch.bfloat16
    assert apply_variant("noremat") is False and not L.GQA_EXPAND
    apply_variant("opt")
    assert L.CAST_PARAMS_ONCE and L.XENT_SEQ_CHUNK == 512
    apply_variant("base")
    assert L.SCORE_DTYPE == torch.float32 and L.XENT_SEQ_CHUNK == 0
    assert not (L.GQA_EXPAND or L.CAST_PARAMS_ONCE)


def test_seq_par_policy_spec():
    p, r = get_policy("seq_par"), jax_policy("seq_par")
    assert p.spec("batch", "seq", "act_d")[1] == "model"
    assert p.spec("batch", "logit_seq", "vocab")[2] == "model"
    for axes in (("batch", "seq", "act_d"), ("batch", "logit_seq",
                                             "vocab")):
        assert tuple(p.spec(*axes)) == tuple(r.spec(*axes))


def test_fsdp_all_policy_spec():
    p, r = get_policy("fsdp_all"), jax_policy("fsdp_all")
    assert tuple(p.spec("heads")) == (None,)                 # no TP
    assert p.spec("experts")[0] == "model"                   # EP kept
    s = p.spec("experts", "d_model", "moe_ff")
    assert s[0] == "model" and s[1] == "data"
    for axes in (("heads",), ("experts",), ("experts", "d_model",
                                            "moe_ff")):
        assert tuple(p.spec(*axes)) == tuple(r.spec(*axes))


# ------------------------------------------- each knob against the reference
def _set(knob, on):
    """The knob in both packages."""
    if knob == "bf16score":
        L.SCORE_DTYPE = torch.bfloat16 if on else torch.float32
        JL.SCORE_DTYPE = jnp.bfloat16 if on else jnp.float32
    elif knob == "gqaexpand":
        L.GQA_EXPAND = JL.GQA_EXPAND = on
    elif knob == "bf16cast":
        L.CAST_PARAMS_ONCE = JL.CAST_PARAMS_ONCE = on
    elif knob == "xentchunk":
        L.XENT_SEQ_CHUNK = JL.XENT_SEQ_CHUNK = 8 if on else 0


# (arch, compute dtype, what is compared, rtol, atol): both packages
# round the same values at the same points, so the port stays within a
# few bf16 ulps of the reference (bf16 scores and casts) or at f32 parity
KNOBS = {"bf16score": ("qwen1.5-0.5b", "f32", "logits", 0.0, 2e-3),
         "gqaexpand": ("phi3-medium-14b", "f32", "logits", 1e-5, 1e-5),
         "bf16cast": ("qwen1.5-0.5b", "bf16", "logits", 0.0, 2e-3),
         "xentchunk": ("qwen1.5-0.5b", "f32", "loss", 1e-5, 1e-6)}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_matches_reference(knob):
    arch, dtype, what, rtol, atol = KNOBS[knob]
    jm, jp, jb, tm, tp, tb = _models(arch, dtype=dtype)
    _set(knob, True)
    if what == "logits":
        V = tm.cfg.vocab_size
        got = _np(tm.forward(tp, tb))[..., :V]
        want = _np(jm.forward(jp, jb))[..., :V]
    else:
        got = _np(tm.loss(tp, tb)[1]["loss"])
        want = _np(jm.loss(jp, jb)[1]["loss"])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)

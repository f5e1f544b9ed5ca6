"""The port's Trainer on the CPU: deterministic restore, fault tolerance,
parity with the JAX Trainer, and images shared with it.

Ports tests/test_determinism.py (a run that crashes at step 7 and
restores from the step-4 image gives bitwise the losses and params of the
run that never crashed; idempotent double restore; exact data cursor;
async image == sync image) and the trainer tests of
tests/test_trainer_fault.py:66-126 to ``repro_torch``.  Then across the
packages: started from the same numpy params and optimizer state (f32, no
remat), the JAX and the port's trainers agree over 6 steps to rtol 1e-4;
their images name the same entries with the same shapes and dtypes; and
each restores the other's image and continues as the writer does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.snapshot_io import SnapshotStore as JaxStore
from repro.runtime.trainer import TrainConfig as JaxTrainConfig
from repro.runtime.trainer import Trainer as JaxTrainer
from repro.sharding import get_policy
from repro_torch.api import CheckpointOptions
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.core.snapshot_io import SnapshotStore
from repro_torch.data import TokenPipeline
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.lm import LM
from repro_torch.runtime.fault import StragglerMonitor
from repro_torch.runtime.trainer import (SimulatedFailure, TrainConfig,
                                         Trainer, loss_and_grads,
                                         run_with_restarts)

ARCH = "qwen1.5-0.5b"
POLICY = get_policy("baseline")
TCFG = TrainConfig(batch_size=2, seq_len=32, total_steps=16, ckpt_every=4,
                   compute_dtype=torch.float32, remat=False)
PARITY_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke shapes run fastest on one thread; with several test workers
    on the machine, torch's default of one thread per core makes every
    small op wait on the others' workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_trainer(run_dir, arch=ARCH, tcfg=TCFG, **kw):
    return Trainer(get_smoke_config(arch), tcfg, run_dir, device="cpu", **kw)


def _leaves(t):
    return flatten_with_paths(t.params)


def _assert_params_equal(a, b):
    a, b = _leaves(a), _leaves(b)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------ tests/test_determinism
@pytest.mark.parametrize("arch", [ARCH, "mamba2-2.7b", "qwen3-moe-30b-a3b",
                                  "h2o-danube-1.8b", "qwen2-vl-7b",
                                  "jamba-v0.1-52b", "phi3-medium-14b",
                                  "deepseek-coder-33b",
                                  "qwen3-moe-235b-a22b"])
def test_bitwise_deterministic_restart(tmp_path, arch):
    t_ref = make_trainer(str(tmp_path / "ref"), arch)
    t_ref.run(12)
    ref_losses = list(t_ref.metrics_history["loss"])
    out = run_with_restarts(
        lambda: make_trainer(str(tmp_path / "crash"), arch),
        total_steps=12, failures={7: "crash"})
    assert out["restarts"] == 1
    assert out["steps"] == 12
    np.testing.assert_array_equal(np.float64(ref_losses[-8:]),
                                  np.float64(out["loss_history"][-8:]))
    _assert_params_equal(t_ref, out["trainer"])
    a, b = t_ref.opt_state, out["trainer"].opt_state
    assert int(a.step) == int(b.step) == 12
    for k, v in flatten_with_paths(a).items():
        assert torch.equal(v, flatten_with_paths(b)[k]), k


def test_moe_step_reports_aux_loss(tmp_path):
    """A MoE config's step metrics carry the load-balance loss, as the
    reference's do, and the loss minimised is loss + 0.01 * aux."""
    t = make_trainer(str(tmp_path / "moe"), "qwen3-moe-30b-a3b")
    t.initialize()
    m = t._train_step(t._batch())
    assert float(m["aux_loss"]) > 0
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_double_restore_is_idempotent(tmp_path):
    t = make_trainer(str(tmp_path / "a"))
    t.run(5)
    t.engine.checkpoint(t.step)
    r1 = make_trainer(str(tmp_path / "a"))
    r1.restore()
    r2 = make_trainer(str(tmp_path / "a"))
    r2.restore()
    assert r1.step == r2.step == 5
    _assert_params_equal(r1, r2)
    _assert_params_equal(r1, t)


def test_data_pipeline_cursor_restores_exactly(tmp_path):
    t = make_trainer(str(tmp_path / "c"))
    t.run(6)
    t.engine.checkpoint(t.step)
    expected_next = t.pipeline.peek()
    r = make_trainer(str(tmp_path / "c"))
    r.restore()
    np.testing.assert_array_equal(expected_next["tokens"],
                                  r.pipeline.peek()["tokens"])


def test_async_mode_same_result_as_sync(tmp_path):
    """The async image holds step k's state although the optimizer then
    updates the same tensors in place."""
    t_s = make_trainer(str(tmp_path / "sync"),
                       tcfg=dataclasses.replace(
                           TCFG, ckpt=CheckpointOptions(mode="sync")))
    t_a = make_trainer(str(tmp_path / "async"),
                       tcfg=dataclasses.replace(
                           TCFG, ckpt=CheckpointOptions(mode="async")))
    t_s.run(6)
    t_a.run(6)                       # steps 5-6 run over the step-4 image
    r_s = make_trainer(str(tmp_path / "sync"))
    r_a = make_trainer(str(tmp_path / "async"))
    r_s.restore(step=4)
    r_a.restore(step=4)
    assert r_s.step == r_a.step == 4
    _assert_params_equal(r_s, r_a)
    assert not torch.equal(_leaves(r_a)["final_norm/scale"],
                           _leaves(t_a)["final_norm/scale"])


# ---------------------------------------------- tests/test_trainer_fault
def _fault_tcfg(**kw):
    return TrainConfig(batch_size=2, seq_len=32, total_steps=64, lr=5e-3,
                       warmup_steps=2, compute_dtype=torch.float32,
                       remat=False, **kw)


def test_periodic_checkpoints_created(tmp_path):
    t = make_trainer(str(tmp_path / "r"), tcfg=_fault_tcfg(ckpt_every=3))
    t.run(7)
    assert SnapshotStore(str(tmp_path / "r")).list_steps() == [3, 6]


def test_loss_decreases_over_training(tmp_path):
    t = make_trainer(str(tmp_path / "r"), tcfg=_fault_tcfg())
    out = t.run(40)
    losses = t.metrics_history["loss"]
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.02
    assert out["steps"] == 40


def test_multiple_failures_to_completion(tmp_path):
    out = run_with_restarts(
        lambda: make_trainer(str(tmp_path / "r"),
                             tcfg=_fault_tcfg(ckpt_every=2)),
        total_steps=12, failures={5: "crash", 9: "crash"})
    assert out["steps"] == 12
    assert out["restarts"] == 2


def test_failure_before_any_checkpoint(tmp_path):
    def mk():
        return make_trainer(str(tmp_path / "r"),
                            tcfg=_fault_tcfg(ckpt_every=50))
    t = mk()
    t.initialize()
    with pytest.raises(SimulatedFailure):
        t.run(10, fail_at=3)
    t2 = mk()
    with pytest.raises(FileNotFoundError):
        t2.restore()                       # no image: the caller re-inits
    t2.initialize()
    t2.run(4)
    assert t2.step == 4


def test_straggler_triggers_jit_checkpoint(tmp_path):
    t = make_trainer(str(tmp_path / "r"), tcfg=_fault_tcfg())
    t.straggler = StragglerMonitor(min_samples=4, threshold=3.0)
    t.run(8)
    t.run(1, straggle_at=8)               # injected 0.25 s stall
    assert t.jit_ckpt.triggered, "straggler did not trigger JIT checkpoint"
    assert SnapshotStore(str(tmp_path / "r")).list_steps()


def test_keep_gc_bounds_disk(tmp_path):
    tcfg = TrainConfig(batch_size=2, seq_len=32, total_steps=32,
                       ckpt_every=1, compute_dtype=torch.float32,
                       remat=False, ckpt=CheckpointOptions(keep=2))
    t = make_trainer(str(tmp_path / "r"), tcfg=tcfg)
    t.run(6)
    assert SnapshotStore(str(tmp_path / "r")).list_steps() == [5, 6]


def test_preempt_checkpoints_and_yields(tmp_path):
    t = make_trainer(str(tmp_path / "r"))
    out = t.run_until(10, preempt=lambda: t.step == 3)
    assert out["preempted"] and out["step"] == 3
    assert SnapshotStore(str(tmp_path / "r")).list_steps() == [3]
    r = make_trainer(str(tmp_path / "r"))
    r.restore()
    assert r.step == 3
    _assert_params_equal(r, t)


def test_trainer_through_kernels_matches_plain_trainer(tmp_path):
    """The kernel seam (``model=LM(use_kernels=True)``) driven by the
    trainer: the reference's tests/test_kernels.py:210-238 path.  Both
    trainers remat.  On the CPU the ops run their plain versions forward
    and their oracles backward, so step 0's loss and every grad leaf
    follow the plain trainer's at the reference's kernel-grad tolerance
    (rtol = atol = 1e-5, tests/test_kernels.py:205-206).  The 6 steps'
    losses are held at PARITY_RTOL: AdamW divides by sqrt(v), so its first
    steps move each param by about lr·sign(g), and a grad at rounding level
    whose sign differs between the two backward paths moves its param by
    up to 2·lr; the losses then part at ~1e-5 relative."""
    cfg = get_smoke_config(ARCH)
    trainers = [make_trainer(
        str(tmp_path / name), tcfg=_fault_tcfg(),
        model=LM(cfg, compute_dtype=torch.float32, remat=True,
                 use_kernels=kernels, device="cpu"))
        for name, kernels in (("k", True), ("p", False))]
    tk, tp = trainers
    for t in trainers:
        t.initialize()
    tokens = TokenPipeline(cfg, 2, 32, seed=tk.tcfg.seed).next()["tokens"]
    batch = {"tokens": torch.as_tensor(tokens).long()}   # step 0's batch
    (mk, gk), (mp, gp) = (loss_and_grads(t.model, t.params, batch)
                          for t in trainers)
    np.testing.assert_allclose(float(mk["loss"]), float(mp["loss"]),
                               rtol=1e-5, atol=1e-5)
    gp = flatten_with_paths(gp)
    for k, g in flatten_with_paths(gk).items():
        np.testing.assert_allclose(g.numpy(), gp[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for t in trainers:
        t.run(6)
    np.testing.assert_allclose(tk.metrics_history["loss"],
                               tp.metrics_history["loss"], rtol=PARITY_RTOL)


def test_trainer_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(get_smoke_config(ARCH), TCFG, str(tmp_path / "t"))


# ------------------------------------------------------- across packages
PARITY_TCFG = dict(batch_size=2, seq_len=32, total_steps=16, lr=3e-3,
                   warmup_steps=4, remat=False)


def _jax_trainer(run_dir, mesh, arch=ARCH, **kw):
    tcfg = JaxTrainConfig(compute_dtype=jnp.float32,
                          **dict(PARITY_TCFG, **kw))
    return JaxTrainer(jax_smoke_config(arch), tcfg, mesh, POLICY, run_dir)


def _port_trainer(run_dir, arch=ARCH, **kw):
    tcfg = TrainConfig(compute_dtype=torch.float32,
                       **dict(PARITY_TCFG, **kw))
    return make_trainer(run_dir, arch, tcfg=tcfg)


def _np_state(jt, seed=0):
    """Params and an AdamW state mid-run (step 3, non-zero moments), as
    numpy, drawn once for both packages."""
    rng = np.random.default_rng(seed)
    draw = lambda s, scale: (rng.normal(0.0, scale, s.shape)   # noqa: E731
                             .astype(np.float32))
    abstract = jt.model.init_abstract()
    params = jax.tree.map(lambda a: draw(a, 0.05), abstract)
    m = jax.tree.map(lambda a: draw(a, 1e-3), abstract)
    v = jax.tree.map(lambda a: np.abs(draw(a, 1e-3)) ** 2, abstract)
    return params, (np.int32(3), m, v)


def _load(jt, tt, params, opt):
    from repro.optim.adamw import OptState as JaxOptState
    step, m, v = opt
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.opt_state = JaxOptState(step=jnp.asarray(step),
                               m=jax.tree.map(jnp.asarray, m),
                               v=jax.tree.map(jnp.asarray, v))
    tt.params = params_from_numpy(params, "cpu")
    tt.opt_state = opt_state_from_numpy(opt, "cpu")


def test_trainer_losses_match_jax(tmp_path, mesh1):
    jt = _jax_trainer(str(tmp_path / "jax"), mesh1)
    tt = _port_trainer(str(tmp_path / "port"))
    _load(jt, tt, *_np_state(jt))
    jt.run(6)
    tt.run(6)
    np.testing.assert_allclose(tt.metrics_history["loss"],
                               jt.metrics_history["loss"],
                               rtol=PARITY_RTOL)
    assert int(tt.opt_state.step) == int(jt.opt_state.step) == 9


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "h2o-danube-1.8b",
                                  "phi3-medium-14b", "deepseek-coder-33b",
                                  "qwen3-moe-235b-a22b"])
def test_zoo_trainer_losses_match_jax(arch, tmp_path):
    """MoE (the aux loss in the total, capacity drops; qwen3-moe-235b's
    GQA group of 2 at its smoke config, 16 at full width), the sliding
    window and the dense arches with an untied head: 6 steps of both
    packages' trainers from the same params and AdamW state, as
    ``test_trainer_losses_match_jax``.  The JAX MoE block needs the
    mesh's expert axis: a (1, 1) ``("data", "model")`` mesh."""
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    jt = _jax_trainer(str(tmp_path / "jax"), mesh, arch)
    tt = _port_trainer(str(tmp_path / "port"), arch)
    _load(jt, tt, *_np_state(jt))
    jt.run(6)
    tt.run(6)
    np.testing.assert_allclose(tt.metrics_history["loss"],
                               jt.metrics_history["loss"],
                               rtol=PARITY_RTOL)
    assert int(tt.opt_state.step) == int(jt.opt_state.step) == 9


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-7b"])
def test_multimodal_trainer_losses_match_jax(arch, tmp_path, mesh1):
    """The encoder-decoder (frames) and the VLM (vision embeddings, the
    loss masked under them): 4 steps of both packages' trainers from the
    same params and AdamW state."""
    jt = _jax_trainer(str(tmp_path / "jax"), mesh1, arch)
    tt = _port_trainer(str(tmp_path / "port"), arch)
    _load(jt, tt, *_np_state(jt))
    jt.run(4)
    tt.run(4)
    np.testing.assert_allclose(tt.metrics_history["loss"],
                               jt.metrics_history["loss"],
                               rtol=PARITY_RTOL)
    assert int(tt.opt_state.step) == int(jt.opt_state.step) == 7


def _image_entries(run, step):
    reader = JaxStore(run).reader(step)
    try:
        out = {}
        for name in reader.state_names():
            for key in reader.entry_names(name):
                e = reader.load_entry(name, key)
                out[f"{name}/{key}"] = (tuple(e["shape"]), e["dtype"])
        return out, sorted(reader.host_state())
    finally:
        reader.close()


def _state(t):
    """A trainer's params and AdamW state as numpy, by image name, from
    either package."""
    if isinstance(t, Trainer):
        tree, flat = {"params": t.params, "opt": t.opt_state}, \
            flatten_with_paths
    else:
        from repro.core.device_plugin import flatten_with_paths as flat
        tree = {"params": t.params, "opt": t.opt_state}
    return {k: np.asarray(v) for k, v in flat(tree).items()}


#: the untied-head case: deepseek-coder-33b's smoke config
UNTIED = "deepseek-coder-33b"


@pytest.mark.parametrize("writer,arch", [
    pytest.param("port", ARCH, id="port"), pytest.param("jax", ARCH, id="jax"),
    pytest.param("port", UNTIED, id=f"port-{UNTIED}"),
    pytest.param("jax", UNTIED, id=f"jax-{UNTIED}")])
def test_training_images_restore_across_packages(writer, arch, tmp_path,
                                                 mesh1):
    """One package writes a training image at step 3; a fresh trainer of
    the other package restores it bit for bit (params and AdamW state),
    and both continue 3 steps with the same losses (to the
    trainer-parity tolerance).  The other package's own step-3 image of
    the same state names the same entries with the same shapes and
    dtypes.  qwen1.5's tied embedding, and deepseek-coder's untied
    embedding and head."""
    run = str(tmp_path / "run")
    jt = _jax_trainer(run if writer == "jax" else str(tmp_path / "j"),
                      mesh1, arch, ckpt_every=3)
    tt = _port_trainer(run if writer == "port" else str(tmp_path / "t"),
                       arch, ckpt_every=3)
    _load(jt, tt, *_np_state(jt, seed=1))
    src, other = (tt, jt) if writer == "port" else (jt, tt)
    src.run(3)
    written = _state(src)
    if arch == UNTIED:
        assert "params/lm_head" in written
    if writer == "port":
        dst = _jax_trainer(run, mesh1, arch)
    else:
        dst = _port_trainer(run, arch)
    assert dst.restore() == 3
    restored = _state(dst)
    assert sorted(restored) == sorted(written)
    for k, v in written.items():
        assert v.dtype == restored[k].dtype, k
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    assert dst.pipeline.state() == src.pipeline.state()
    other.run(3)
    assert _image_entries(run, 3) == _image_entries(
        str(tmp_path / ("j" if writer == "port" else "t")), 3)
    src.run(3)
    dst.run(3)
    np.testing.assert_allclose(dst.metrics_history["loss"][-3:],
                               src.metrics_history["loss"][-3:],
                               rtol=PARITY_RTOL)


def test_training_images_name_the_same_entries(tmp_path, mesh1):
    jt = _jax_trainer(str(tmp_path / "jax"), mesh1, ckpt_every=2)
    tt = _port_trainer(str(tmp_path / "port"), ckpt_every=2)
    jt.initialize()
    tt.initialize()
    jt.run(2)
    tt.run(2)
    want = _image_entries(str(tmp_path / "jax"), 2)
    got = _image_entries(str(tmp_path / "port"), 2)
    assert got == want
    shape, dtype = got[0]["train_state/opt/step"]
    assert shape == () and np.dtype(dtype) == np.int32
    assert got[1] == ["data_cursor", "trainer"]

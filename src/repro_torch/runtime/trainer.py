"""Training runtime with transparent unified checkpointing.

Port of the reference's ``runtime/trainer.py``.  The loop contains no
checkpoint logic for its *state*: the session is attached to a state
provider and captures params and optimizer state (device) plus the data
cursor and the trainer's step (host) through plugins.  Periodic and
just-in-time policies drive the same session.  ``run_with_restarts`` is
the failure story: crash (``SimulatedFailure``) -> a fresh ``Trainer`` ->
restore from the newest valid image -> continue, bitwise the run that
never crashed.

Images match the reference's: state ``train_state/{params,opt}`` (the
optimizer as ``opt/step`` int32, ``opt/m/…``, ``opt/v/…``) and host state
``data_cursor`` and ``trainer``, so a trainer of either package resumes
the other's run.

Grads come from ``torch.autograd.grad`` on views of the params (the
counterpart of ``jax.value_and_grad``; nothing accumulates in ``.grad``),
and AdamW updates params and moments in place.  Runs on ``cuda`` unless
the caller passes ``device="cpu"``.

With ``restore_mode="lazy"`` a restore resumes on the params (the default
critical set ``train_state/params``) while the optimizer state streams in
behind; the first step or a preempt dump joins the stream first.  With
``capture="concurrent"`` a periodic checkpoint is a soft-freeze capture
begun at the step and finalized between later steps once its speculation
is done (and at the end of ``run_until``); across ranks, once every
rank's speculation is done (a collective: a rank that validated alone
would wait in the commit barrier for a rank waiting for it in a step).

With ``mesh=`` (a grid of slots on the trainer's device,
``repro_torch.launch.mesh``) and ``policy=`` (default ``"baseline"``),
the state's named shardings (``repro_torch.sharding.state_shardings``)
ride beside it: images hold each tensor's distinct blocks and name the
mesh, and a restore lays the image out on this mesh (identical,
translated or resharded).  Compute is the same whole-tensor step either
way; ``mesh=None`` writes every tensor whole.

With a process mesh (``launch.mesh.ProcessMesh``, one rank per card,
over ``(data, model)``; the launchers' ``data`` = the world size) the
state is laid out as the reference's GSPMD lays it: each rank holds its
block of every param and moment (the policy's ``d_model`` blocks over
``data``; heads, ``d_ff``, vocab and experts over ``model``) and takes
the rows of the global batch at its coordinate over the policy's
data-parallel axes (``dp``; the ranks of one coordinate, over
``model``, take the same rows).  A step runs the model
on the blocks under ``layers.gathering(param_gather(...))``: the model
gathers the top-level leaves once and each super-block's layers inside
its remat unit (``sharding.policy.GatherLeaves``: one all-gather forward
and one reduce-scatter backward for a layer's leaves), so the
backward's recompute gathers each super-block again and a rank holds
its blocks plus one super-block's weights, never a whole copy of the
params.  A leaf the policy's ``tp`` axes cut (heads, ``kv_heads``,
``d_ff``, vocab, where the fitted spec keeps the axes and they divide
the heads) is gathered over its other axes alone, and a rank computes
its own heads, ``d_ff`` columns and vocab rows, each block's output
summed over those ranks (``models/layers.py``); expert leaves are
gathered over the data axes alone, and a rank computes its own experts,
the partial outputs summed over the model ranks (``models/moe.py``);
every other leaf (the norms, the router, the Mamba mixer) is gathered
whole and computed whole by every rank of a data row.  Each token's
gradient is counted once: the loss on the rank's rows is weighted by
its row's share of the global token count over the ranks per row
(``|model|``), the gathers' backward sums over every rank that
gathered, and each sum over the model ranks (a tensor-parallel block's,
the cross-entropy's, the MoE's) sums the grads back, as the transpose
of the reference's ``psum`` does: a rank's input to its heads is a
variable of its own, and the grads of the leaves every rank holds
whole meet in the gathers' sum.  The grads that come
back are the blocks' grads and update the blocks, the clip's norm
counting each distinct block once (replica 0's) over the ranks.  At one
rank every block is its whole leaf and the model reads the blocks as
they are.  With remat off the backward saves every gathered layer:
correct, but the rank then holds the whole params again.  The logged
loss is the global mean; ``gathered`` holds what the last step gathered
(``sharding.policy.GATHERED``: the peak of the live gathered bytes and
the bytes gathered).  Decisions the ranks must take together -- the
just-in-time checkpoint of a straggler, a preemption -- are agreed first
(any rank's flag acts on all); ``fail_at`` and
``ckpt_every`` are the same on every rank by construction.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.api.session import SnapshotWriteFailed
from repro_torch.core.device_plugin import flatten_with_paths, unflatten_like
from repro_torch.core.lazy import covers
from repro_torch.core.snapshot_io import snapshot_dir
from repro_torch.data import TokenPipeline
from repro_torch.data.pipeline import local_rows
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import build_model
from repro_torch.models.layers import gathering, tp_units
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.fault import (JITCheckpointPolicy,
                                       SimulatedFailure, StragglerMonitor)
from repro_torch.sharding import get_policy, state_shardings
from repro_torch.sharding.policy import (GATHERED, local_block, map_tree,
                                         param_gather, row_axes)

PyTree = Any


def loss_and_grads(model, params: PyTree, batch,
                   on_grad: Optional[Callable[[str, torch.Tensor], None]]
                   = None,
                   scale: Optional[Callable[[Dict[str, torch.Tensor]],
                                            torch.Tensor]] = None
                   ) -> Tuple[Dict[str, torch.Tensor], PyTree]:
    """``model.loss``'s metrics and the grads of its total for every
    param (the counterpart of ``jax.value_and_grad``), taken on views of
    the params: nothing accumulates in ``.grad``.  ``on_grad(path,
    grad)`` runs as each param's grad is formed (the dry run lays it out
    over its shards there).  ``scale(metrics)`` weights the total before
    the backward (a rank's share of the global token count)."""
    flat = {k: p.detach().requires_grad_()
            for k, p in flatten_with_paths(params).items()}
    if on_grad is not None:
        for k, t in flat.items():
            t.register_hook(lambda g, k=k: on_grad(k, g))
    total, metrics = model.loss(unflatten_like(params, flat), batch)
    if scale is not None:
        total = total * scale(metrics)
    # a declared leaf no layer reads (pre_mlp_norm without an FFN) gets
    # zeros, as from jax.grad
    grads = torch.autograd.grad(total, list(flat.values()),
                                allow_unused=True, materialize_grads=True)
    return ({k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, dict(zip(flat, grads))))


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 4
    seq_len: int = 64
    lr: float = 3e-4
    warmup_steps: int = 20
    total_steps: int = 200
    ckpt_every: int = 0             # 0 = no periodic checkpoints
    ckpt: CheckpointOptions = dataclasses.field(      # how snapshots
        default_factory=CheckpointOptions)           # are taken
    seed: int = 0
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True


class Trainer:
    """`model=` lets a caller pass its own model (e.g. one built with
    ``use_kernels=True``); its compute dtype and remat then stand in for
    the config's.  `mesh` / `policy` lay the state over a mesh of slots
    (see the module docstring); the device defaults to the mesh's."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, run_dir: str,
                 session: Optional[CheckpointSession] = None, *,
                 device: DeviceLike = None, model=None, mesh=None,
                 policy=None):
        self.cfg = cfg
        self.tcfg = tcfg
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self.model = model if model is not None else build_model(
            cfg, compute_dtype=tcfg.compute_dtype, remat=tcfg.remat,
            device=self.device)
        self.opt = AdamW(lr=warmup_cosine(tcfg.lr, tcfg.warmup_steps,
                                          tcfg.total_steps))
        self.pipeline = TokenPipeline(cfg, tcfg.batch_size, tcfg.seq_len,
                                      seed=tcfg.seed)
        self.mesh = mesh
        # {"params", "opt"} named shardings on the mesh (None: whole)
        self.shardings = (state_shardings(self.model, mesh, policy)
                          if mesh is not None else None)
        # across processes: the process mesh this rank is a slot of
        self.ranks = mesh if getattr(mesh, "is_process_mesh", False) \
            else None
        if self.ranks is not None:
            # the policy's data-parallel axes split the batch, those
            # that divide it (the reference's layout; none: every rank
            # takes it whole): this rank's data coordinate, their size
            # and their ranks (its share of the tokens), and how many
            # ranks compute each data row
            dp = get_policy(policy or "baseline").dp
            rows = row_axes(self.ranks, dp, tcfg.batch_size)
            self._row, size = self.ranks.coord(rows)
            self._data = self.ranks.axis_group(rows)
            self._per_row = self.ranks.world // size
            # the leaves whose block this rank holds replica 0 of: the
            # clip's norm counts each block once over the ranks
            coord = self.ranks.local_coord
            self._primary = {
                k: sh.replica_ids(tuple(a.shape))[coord] == 0
                for (k, a), sh in zip(
                    flatten_with_paths(self.model.init_abstract()).items(),
                    flatten_with_paths(self.shardings["params"]).values())}
            # the model's gather (None at one rank: each block is whole),
            # expert leaves over the data axes alone, the leaves the tp
            # axes cut over their other axes
            self._gather = param_gather(
                self.shardings["params"], self.model.param_axes(), dp, rows,
                tp_units(cfg))
        # what the last step gathered (0 without ranks, or at one)
        self.gathered = {"gathered_peak_bytes": 0, "gathered_bytes": 0}
        self.params = None
        self.opt_state = None
        self.step = 0
        self.metrics_history: Dict[str, list] = {"loss": [], "step_s": []}
        self.straggler = StragglerMonitor()
        if session is None:
            opts = tcfg.ckpt
            if (opts.restore_mode == "lazy"
                    and opts.critical_states is None):
                # resume-before-read default: the first step's forward
                # touches params; the optimizer state streams in behind
                opts = opts.replace(critical_states=("train_state/params",))
            session = CheckpointSession(run_dir, opts, device=self.device,
                                        mesh=mesh)
        self.session = session
        # lazy restore: the optimizer template whose leaves are still
        # streaming; joined right before the first step runs
        self._pending_opt_template = None
        self.engine = session.engine
        # transparent wiring: live state via provider, host bits via plugins
        self.session.attach(
            lambda: {"train_state": {"params": self.params,
                                     "opt": self.opt_state}},
            {"train_state": self.shardings} if mesh is not None else None)
        self.session.register_host_state(
            "data_cursor", lambda: self.pipeline.state(),
            lambda st: self.pipeline.restore_state(st))
        self.session.register_host_state(
            "trainer", lambda: {"step": self.step,
                                "loss_hist": self.metrics_history["loss"][-50:]},
            self._restore_trainer_state)
        self.jit_ckpt = JITCheckpointPolicy(self.session)

    def _restore_trainer_state(self, st):
        self.step = st["step"]
        self.metrics_history["loss"] = list(st["loss_hist"])

    # ------------------------------------------------------------- steps
    def _train_step(self, batch) -> Dict[str, torch.Tensor]:
        if self.ranks is not None:
            return self._train_step_ranks(batch)
        metrics, grads = loss_and_grads(self.model, self.params, batch)
        _, _, om = self.opt.update(grads, self.opt_state, self.params)
        return {**metrics, **om}

    def _train_step_ranks(self, batch) -> Dict[str, torch.Tensor]:
        """One step over the ranks: local loss and grads on the blocks,
        weighted by the rank's token share, the model gathering each
        layer where it reads it and reduce-scattering its grads; a
        blockwise update."""
        group, data = self.ranks.group, self._data
        ntok = {}

        def share(metrics):
            # the data row's share of the global tokens, over the ranks
            # that compute it: summed over every rank, each token counts
            # once
            n = metrics["ntokens"].float()
            ntok["local"] = n.detach()
            ntok["global"] = data.all_reduce(n.detach().clone())
            return n.detach() / (ntok["global"] * self._per_row)

        GATHERED.begin()
        with gathering(self._gather):
            metrics, grads = loss_and_grads(self.model, self.params, batch,
                                            scale=share)
        self.gathered = GATHERED.read()

        def grad_sq(g_flat):
            total = sum(torch.sum(torch.square(g.float()))
                        for k, g in g_flat.items() if self._primary[k])
            return group.all_reduce(torch.as_tensor(
                total, dtype=torch.float32, device=self.device))

        _, _, om = self.opt.update(grads, self.opt_state, self.params,
                                   grad_sq=grad_sq)
        if data.world > 1:
            metrics["loss"] = data.all_reduce(
                metrics["loss"] * ntok["local"]) / ntok["global"]
            metrics["ntokens"] = ntok["global"]
        return {**metrics, **om}

    def initialize(self) -> None:
        self.params = self.model.init(self.tcfg.seed)
        if self.ranks is not None:
            # this rank's block of every param; the whole tree goes
            self.params = map_tree(local_block, self.params,
                                   self.shardings["params"])
        self.opt_state = self.opt.init(self.params)
        self.step = 0

    def restore(self, step: Optional[int] = None) -> int:
        """Unified restore (the session pushes host state back through
        its plugins); a trainer with nothing loaded takes its tree
        structure from abstract templates.  In lazy mode this returns
        once the critical set (by default the params) is placed; the
        optimizer state keeps streaming and is joined right before the
        first step (resume-before-read)."""
        if self.params is None or self.opt_state is None:
            # nothing loaded, or a lazy restore whose stream failed
            # before the optimizer state landed (the retry)
            abstract = self.model.init_abstract()
            template = {"params": abstract,
                        "opt": self.opt.init_abstract(abstract)}
        else:
            template = {"params": self.params, "opt": self.opt_state}
        shardings = self.shardings
        if self.session.options.restore_mode == "lazy":
            restored = self.session.restore(
                step=step, wait="critical", mesh=self.mesh,
                shardings={"train_state": shardings} if shardings else None)
            engine = self.session.engine
            if not covers(self.session.options.critical_states,
                          "train_state", "params", template["params"]):
                # a critical set that leaves params leaves in the stream:
                # join it, decided by the spec and not by which leaves
                # happen to have landed
                restored = self.session.restore_barrier()
            raw = restored["train_state"]
            self.params = engine.retree(template["params"], raw["params"])
            if self.session.lazy_pending:
                self._pending_opt_template = template["opt"]
            else:
                self.opt_state = engine.retree(template["opt"], raw["opt"])
            return self.step
        restored = self.session.restore_into(template, state="train_state",
                                             step=step, mesh=self.mesh,
                                             shardings=shardings)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        return self.step

    def _finish_lazy_restore(self) -> None:
        """Join the background stream and adopt the streamed optimizer
        state — on first touch (right before the first step, or before a
        preempt dump captures the live roots)."""
        if self._pending_opt_template is None:
            return
        template, self._pending_opt_template = \
            self._pending_opt_template, None
        full = self.session.restore_barrier()
        self.opt_state = self.session.engine.retree(
            template, full["train_state"]["opt"])

    def release(self) -> None:
        """Drop every reference this trainer and its engine hold to the
        job's device state (params, optimizer state, a lazy template), so
        it is freed at once: the session's state provider otherwise keeps
        the trainer in a reference cycle until a garbage collection."""
        self.params = self.opt_state = self._pending_opt_template = None
        self.engine.release()

    def _batch(self) -> Dict[str, torch.Tensor]:
        batch = self.pipeline.next()
        if self.ranks is not None:
            batch = local_rows(batch, self._row, self._data.world)
        out = {k: torch.as_tensor(v).to(self.device)
               for k, v in batch.items()}
        out["tokens"] = out["tokens"].long()
        return out

    # ------------------------------------------------------------- loop
    def run_until(self, target_step: int,
                  preempt: Optional[Callable[[], bool]] = None,
                  fail_at: Optional[int] = None,
                  straggle_at: Optional[int] = None) -> Dict[str, Any]:
        """Run to `target_step`; resumable and preemptible.

        `preempt` is polled between steps (the SIGTERM-trap analogue): when
        it fires the trainer checkpoints-on-signal (``session.frozen`` at
        the current step) and returns with ``preempted=True``.  A failed
        async snapshot write aborts the run with
        :class:`SnapshotWriteFailed`.
        """
        if self.params is None:
            self.initialize()
        t_loop = time.perf_counter()
        executed = 0
        preempted = False
        ckpt_path = None
        while self.step < target_step:
            if self.session.write_error is not None:
                raise SnapshotWriteFailed(
                    f"async snapshot write failed at step {self.step}: "
                    f"{self.session.write_error}")
            handle = self.session.concurrent_capture
            if handle is not None and self._all_ranks(
                    handle.speculation_done):
                # the soft-freeze capture finished speculating (on every
                # rank): take its short validate pause now, between steps
                self.session.checkpoint_finalize()
            if preempt is not None and self._agree(preempt()):
                # a dump captures the live roots: the streamed optimizer
                # state must have landed, and an open soft-freeze capture
                # must settle (its validate pause re-reads the roots)
                self._finish_lazy_restore()
                self.session.checkpoint_finalize()
                if (self.session.last_commit_step == self.step
                        and self.session.latest_step() == self.step):
                    # THIS incarnation committed an image of this exact
                    # step: yield it instead of re-dumping the same state
                    ckpt_path = snapshot_dir(self.session.run_dir,
                                             self.step)
                else:
                    with self.session.frozen(self.step) as snap:
                        pass                           # dump-and-yield
                    ckpt_path = snap.path
                preempted = True
                break
            if fail_at is not None and self.step == fail_at:
                raise SimulatedFailure(f"injected failure at {self.step}")
            batch = self._batch()
            # first touch: batch prep (and everything since restore
            # returned) overlapped the optimizer state's stream
            self._finish_lazy_restore()
            t0 = time.perf_counter()
            if straggle_at is not None and self.step == straggle_at:
                time.sleep(0.25)                       # injected straggler
            metrics = self._train_step(batch)
            loss = float(metrics["loss"])
            self.metrics_history["loss"].append(loss)
            dt = time.perf_counter() - t0
            self.metrics_history["step_s"].append(dt)
            self.step += 1
            executed += 1
            if self._agree(self.straggler.record(dt)):
                self.jit_ckpt.on_signal(self.step)     # just-in-time ckpt
            if (self.tcfg.ckpt_every
                    and self.step % self.tcfg.ckpt_every == 0):
                if self.session.options.capture == "concurrent":
                    # soft-freeze: brief pin pause, then the loop keeps
                    # stepping while the image is speculated; finalized
                    # by the poll above or the settle below
                    self.session.checkpoint_begin(self.step)
                else:
                    self.session.checkpoint(self.step)
        # never leave a capture half-done across run_until boundaries
        self.session.checkpoint_finalize()
        return {"steps": executed, "step": self.step,
                "preempted": preempted, "ckpt_path": ckpt_path,
                "loss": (self.metrics_history["loss"][-1]
                         if self.metrics_history["loss"] else None),
                "wall_s": time.perf_counter() - t_loop}

    def _agree(self, flag: bool) -> bool:
        """A decision every rank takes together: true on all when true
        on any (a collective; this process alone without ranks)."""
        return (self.ranks.group.any_rank(flag) if self.ranks is not None
                else flag)

    def _all_ranks(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on all of them (a
        collective; this process alone without ranks)."""
        return (self.ranks.group.all_ranks(flag) if self.ranks is not None
                else flag)

    def run(self, num_steps: int, fail_at: Optional[int] = None,
            straggle_at: Optional[int] = None) -> Dict[str, Any]:
        if self.params is None:
            self.initialize()
        t_loop = time.perf_counter()
        self.run_until(self.step + num_steps, fail_at=fail_at,
                       straggle_at=straggle_at)
        self.session.wait_pending()
        return {"steps": self.step,
                "loss": self.metrics_history["loss"][-1],
                "wall_s": time.perf_counter() - t_loop}


def run_with_restarts(make_trainer, total_steps: int,
                      failures: Dict[int, str]) -> Dict[str, Any]:
    """Drive training to `total_steps`, surviving injected failures.

    failures: {step: kind}; the trainer is rebuilt from scratch and
    restored from the newest valid image after each crash (node-replacement
    semantics).
    """
    restarts = 0
    trainer = make_trainer()
    trainer.initialize()
    pending = dict(failures)
    while trainer.step < total_steps:
        fail_at = min((s for s in pending if s >= trainer.step),
                      default=None)
        try:
            trainer.run(total_steps - trainer.step, fail_at=fail_at)
        except SimulatedFailure:
            pending.pop(fail_at, None)
            restarts += 1
            # a dead process's writer dies with it; this one lives on in
            # the process: let the images it captured land (or fail, and
            # leave no image) before the replacement writes the same
            # steps into the same files
            try:
                trainer.session.wait_pending()
            except Exception:                          # noqa: BLE001
                pass
            trainer = make_trainer()                   # replacement node
            trainer.restore()                          # newest valid image
    return {"steps": trainer.step, "restarts": restarts,
            "loss_history": trainer.metrics_history["loss"],
            "trainer": trainer}

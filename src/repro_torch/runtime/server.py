"""Batched decode server with transparent serving-state snapshots.

Port of the reference's ``runtime/server.py``.  Serving state (params +
KV or SSM cache + generated tokens + position) is device state like any
other: the engine checkpoints a half-finished generation and a fresh
server resumes it token-exact — the paper's inference-side story (snapshotting serving
processes for fast cold start).  Images match the reference's: state
``serve_state/{params,cache}`` and host state ``decode_cursor``, so a
server of either package resumes the other's generation.

Runs on ``cuda`` unless the caller passes ``device="cpu"``.  With
``restore_mode="lazy"`` a restore resumes on the params (the default
critical set ``serve_state/params``) while the cache streams in behind;
the first decode step, a checkpoint or a preempt dump joins the stream
first.

With ``mesh=`` and ``policy=`` (default ``"baseline"``) the params and the
cache carry named shardings on the mesh (the cache's batch- or
sequence-sharded by the reference's rule, fitted to its shape), so
images hold each tensor's blocks and a restore lays them out on this
mesh; ``mesh=None`` writes every tensor whole.

With a process mesh (one rank per card, over ``(data, model)``; the
launchers' ``data`` = the world size) the batch and the cache go over
the policy's data-parallel axes (``dp``): each rank prefills and
decodes the rows of the batch at its coordinate over them (the ranks of
one coordinate, over ``model``, the same rows).  Where the policy's
``tp`` axes cut the heads, a rank computes its own heads
(``models/layers.py``) and keeps its ``kv_heads`` block of its rows'
cache, the reference's ``cache_shardings`` rule; a cache leaf the
computation keeps whole (the SSM state, key heads the axes do not
divide) it keeps whole over the off-data axes.  An image holds the block
the policy lays on the rank, cut from it when captured: its rows
(batch-sharded, the cache's ``cache_seq`` losing the contested axis by
the policy's rule) and, over ``model``, its share of ``kv_heads`` (or of
the SSM heads), which a restore gathers back over the axes the rank
keeps whole.  A rank keeps only its blocks of the params: each prefill
and decode step runs the model under
``layers.gathering(param_gather(...))``, which gathers the top-level
leaves once a call and each layer in the model's loop (an expert leaf
over the data axes alone: a rank computes its own experts,
``models/moe.py``; a leaf the ``tp`` axes cut over the others alone),
so a rank holds one layer's weights at a time and no whole tree between
steps (``gathered``: what the last call gathered).  Over a vocab split
a rank's logits are its vocab block, and the greedy pick compares the
ranks' best (``layers.greedy``: the lowest index on a tie, as
``jnp.argmax``).  The tokens are gathered over the ``dp`` axes every
step, so every rank holds the whole generation and rank 0's pack
carries it in the decode cursor.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.api.session import SnapshotWriteFailed
from repro_torch.core.lazy import covers
from repro_torch.data.pipeline import local_rows
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.encdec import build_model
from repro_torch.models.layers import gathering
from repro_torch.runtime.fault import SimulatedFailure
from repro_torch.sharding import get_policy, state_shardings
from repro_torch.sharding.policy import (GATHERED, block_of, gather_leaves,
                                         local_block, map_tree,
                                         param_gather, row_axes)


class DecodeServer:
    def __init__(self, cfg: ModelConfig, run_dir: str, max_seq: int = 256,
                 compute_dtype=torch.float32,
                 options: Optional[CheckpointOptions] = None,
                 device: DeviceLike = None,
                 model=None, mesh=None, policy=None):
        self.cfg = cfg
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        # `model=` lets servers share one model (e.g. one built with
        # use_kernels=True)
        self.model = model if model is not None else build_model(
            cfg, compute_dtype=compute_dtype, device=self.device)
        self.max_seq = max_seq
        self.params = None
        self.cache = None
        self.tokens: Optional[np.ndarray] = None       # generated so far
        self.pos = 0
        if (options is not None and options.restore_mode == "lazy"
                and options.critical_states is None):
            # resume-before-read default: the decode loop touches params
            # at once; the (large) cache streams in behind the server
            options = options.replace(
                critical_states=("serve_state/params",))
        self.mesh = mesh
        self.policy = policy
        self._param_shardings = (
            state_shardings(self.model, mesh, policy)["params"]
            if mesh is not None else None)
        # across processes: this rank's slot, and the model's gather of
        # the params' blocks (None at one rank: each block is whole)
        self.ranks = mesh if getattr(mesh, "is_process_mesh", False) \
            else None
        self._gather = None
        # per cache leaf, the mesh axes a rank keeps it whole over (None
        # or (): its block is what the rank keeps)
        self._cache_axes = self._cache_sh = None
        if self.ranks is not None:
            # the policy's data-parallel axes split a generation's batch
            # (``_split``)
            self._dp = get_policy(policy or "baseline").dp
        # what the last prefill or decode step gathered
        self.gathered = {"gathered_peak_bytes": 0, "gathered_bytes": 0}
        self.session = CheckpointSession(run_dir, options,
                                         device=self.device, mesh=mesh)
        self._pending_cache_template = None   # lazy: cache still streaming
        self.session.attach(
            lambda: {"serve_state": {
                "params": self.params,
                "cache": self._cache_blocks(self.cache)}},
            self._shardings if mesh is not None else None)
        self.session.register_host_state(
            "decode_cursor",
            lambda: {"pos": self.pos, "tokens": self.tokens},
            self._restore_cursor)

    def _split(self, batch: int) -> None:
        """Lay a generation of `batch` rows over the ranks: the
        data-parallel axes that divide it split its rows (``row_axes``;
        none: every rank serves it whole), this rank's coordinate over
        them and their ranks, the model's gather (its MoE's token
        shards, its dense layers' tensor split), and per cache leaf the
        mesh axes off those rows that the rank keeps it whole over: all
        of them, but those of the key heads where the rank computes its
        own."""
        mesh = self.ranks
        rows = row_axes(mesh, self._dp, batch)
        self._row = mesh.coord(rows)[0]
        self._data = mesh.axis_group(rows)
        self._gather = param_gather(self._param_shardings,
                                    self.model.param_axes(), self._dp, rows,
                                    L.tp_units(self.cfg))
        off = tuple(a for a in mesh.axis_names
                    if a not in rows and mesh.shape[a] > 1)
        kv = L.cut(L.tensor_shard(self._gather), "kv_heads")

        def kept(sh, logical):
            if kv is None or "kv_heads" not in logical:
                return off
            held = tuple(a for a in sh._dim_axes(len(logical))[
                logical.index("kv_heads")] if mesh.shape[a] > 1)
            if held != kv.axes:
                raise ValueError(f"the cache's key heads lie over {held}, "
                                 f"the attention's over {kv.axes}")
            return tuple(a for a in off if a not in held)
        self._cache_axes = map_tree(kept, self._cache_shardings(batch),
                                    self.model.cache_axes())

    def _shardings(self, with_cache: bool = True) -> Dict[str, Any]:
        """{"serve_state": {"params", "cache"}} named shardings; the
        cache's need the batch, known once a generation started."""
        out: Dict[str, Any] = {"params": self._param_shardings}
        if with_cache and self.tokens is not None:
            out["cache"] = state_shardings(
                self.model, self.mesh, self.policy,
                batch=int(self.tokens.shape[0]),
                max_seq=self.max_seq)["cache"]
        return {"serve_state": out}

    def _layout(self) -> Dict[str, Any]:
        """A restore's target: this server's mesh and, with one, the
        shardings it knows (a cold server's cache takes its saved
        layout, resolved on the mesh)."""
        return {"mesh": self.mesh,
                "shardings": self._shardings()
                if self.mesh is not None else None}

    def _restore_cursor(self, st) -> None:
        self.pos = int(st["pos"])
        self.tokens = st["tokens"]

    def load(self, params) -> None:
        """Serve `params` (whole tensors).  Across ranks a rank keeps its
        blocks alone, for the image and for compute: each step gathers a
        layer at a time (:meth:`_run`), and the whole tree given here
        is not kept."""
        if self.ranks is not None:
            params = map_tree(local_block, params, self._param_shardings)
        self.params = params

    def _run(self, fn, *args):
        """``fn(self.params, *args)``, a model call, with the params'
        blocks gathered where it reads them; notes what it gathered."""
        if self._gather is None:           # whole params, or one rank
            return fn(self.params, *args)
        GATHERED.begin()
        with gathering(self._gather):
            out = fn(self.params, *args)
        self.gathered = GATHERED.read()
        return out

    def _rows(self, a: np.ndarray) -> np.ndarray:
        """This rank's rows of a batch-major array (all of it alone)."""
        if self.ranks is None:
            return a
        return local_rows({"a": a}, self._row, self._data.world)["a"]

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy next tokens of the whole batch from this rank's logits
        (its vocab block over a vocab split), gathered over the ranks."""
        nxt = L.greedy(logits, L.cut(L.tensor_shard(self._gather), "vocab"))
        if self.ranks is not None:
            nxt = torch.cat(self._data.all_gather(nxt))
        return nxt.cpu().numpy()

    # ------------------------------------------------------------- cache
    def _cache_shardings(self, B: Optional[int] = None):
        """The cache's shardings for this generation's batch (kept)."""
        B = int(self.tokens.shape[0]) if B is None else B
        if self._cache_sh is None or self._cache_sh[0] != B:
            self._cache_sh = (B, state_shardings(
                self.model, self.mesh, self.policy, batch=B,
                max_seq=self.max_seq)["cache"])
        return self._cache_sh[1]

    def _cache_rows(self, blocks):
        """The cache this rank computes with, from its blocks `blocks` (a
        restored image's): each leaf gathered over the axes the rank
        keeps it whole over (a leaf itself where there are none)."""
        if self._cache_axes is None or blocks is None:
            return blocks
        return map_tree(lambda t, sh, ax: gather_leaves(
            [t], [sh], [ax], count=False)[0] if ax else t,
            blocks, self._cache_shardings(), self._cache_axes)

    def _cache_blocks(self, rows):
        """This rank's blocks of the cache `rows` it computes with, as the
        policy lays them (e.g. ``kv_heads`` over ``model``): views of
        `rows`, for an image (a leaf itself where the rank keeps no axis
        whole)."""
        if self._cache_axes is None or rows is None:
            return rows
        return map_tree(lambda t, sh, ax: block_of(t, sh, ax) if ax else t,
                        rows, self._cache_shardings(), self._cache_axes)

    # ------------------------------------------------------------- serving
    def start(self, batch: Dict[str, Any]) -> None:
        """Prefill a batch of prompts (``tokens``, and the ``frames`` of
        an encoder-decoder or the ``vision_embeds`` and ``positions`` of
        a VLM where the batch has them); the cache is padded to the one
        the model declares for max_seq."""
        prompt = np.asarray(batch["tokens"], np.int32)
        B, S = prompt.shape
        if S >= self.max_seq:
            raise ValueError(f"prompt length {S} leaves no room in "
                             f"max_seq={self.max_seq}")
        if self.ranks is not None:
            self._split(B)
        inputs = {"tokens": torch.as_tensor(self._rows(prompt),
                                            dtype=torch.long,
                                            device=self.device)}
        extra = {key: np.asarray(batch[key])
                 for key in ("frames", "vision_embeds", "positions")
                 if batch.get(key) is not None}
        if self.ranks is not None:
            extra = local_rows(extra, self._row, self._data.world)
        for key, v in extra.items():
            inputs[key] = torch.as_tensor(v, device=self.device)
        logits, cache = self._run(self.model.prefill, inputs)
        self.cache = self._pad_cache(
            cache, self.model.cache_abstract(B, self.max_seq))
        nxt = self._next_tokens(logits)
        self.tokens = np.concatenate([prompt, nxt[:, None]], axis=1)
        self.pos = S

    @staticmethod
    def _pad_cache(cache, template):
        """Pad the *attention* KV seq dim (axis 2 of (L, B, S, KV, hd)) to
        that of the matching leaf of `template`, the cache the model
        declares (``cache_abstract``): max_seq, or for an SWA ring
        ``min(max_seq, window)`` (the reference pads the ring to max_seq,
        which loses the window once max_seq exceeds it).  Keyed by leaf
        name, as in the reference: an SSM state h (L, B, nh, P, N) is 5-D
        too and must not be touched."""
        def pad(leaf, length):
            if leaf.dim() == 5 and leaf.shape[2] < length:
                return F.pad(leaf, (0, 0, 0, 0, 0, length - leaf.shape[2]))
            return leaf

        def walk(node, tmpl):
            if isinstance(node, dict):
                return {k: (pad(v, tmpl[k].shape[2]) if k in (
                            "k", "v", "self_k", "self_v")
                            and isinstance(v, torch.Tensor)
                            else walk(v, tmpl[k]))
                        for k, v in node.items()}
            return node
        return walk(cache, template)

    def decode_until(self, target_pos: int,
                     preempt: Optional[Callable[[], bool]] = None,
                     fail_at: Optional[int] = None,
                     straggle_at: Optional[int] = None) -> Dict[str, Any]:
        """Decode to `target_pos`; resumable and preemptible.  `preempt`
        is polled between tokens and triggers a checkpoint-on-signal at
        the current position; a failed async snapshot write aborts the
        generation with :class:`SnapshotWriteFailed`.  As in
        ``Trainer.run_until``, `fail_at` raises ``SimulatedFailure`` at
        that position and `straggle_at` stalls the token there."""
        t0 = time.perf_counter()
        executed = 0
        preempted = False
        ckpt_path = None
        while self.pos < target_pos:
            if self.session.write_error is not None:
                raise SnapshotWriteFailed(
                    f"async snapshot write failed at pos {self.pos}: "
                    f"{self.session.write_error}")
            if preempt is not None and preempt():
                # a dump captures the live roots: the streaming cache
                # must have landed before the freeze
                self._finish_lazy_restore()
                with self.session.frozen(self.pos) as snap:
                    pass                               # dump-and-yield
                ckpt_path = snap.path
                preempted = True
                break
            if fail_at is not None and self.pos == fail_at:
                raise SimulatedFailure(f"injected failure at pos {self.pos}")
            if straggle_at is not None and self.pos == straggle_at:
                time.sleep(0.25)                   # injected straggler
            self._finish_lazy_restore()   # first touch of the cache
            last = torch.as_tensor(self._rows(self.tokens[:, -1]),
                                   dtype=torch.long, device=self.device)
            logits, self.cache = self._run(self.model.decode_step,
                                           self.cache, last, self.pos)
            nxt = self._next_tokens(logits)
            self.tokens = np.concatenate([self.tokens, nxt[:, None]], axis=1)
            self.pos += 1
            executed += 1
        return {"steps": executed, "pos": self.pos, "preempted": preempted,
                "ckpt_path": ckpt_path,
                "wall_s": time.perf_counter() - t0}

    def decode(self, n_tokens: int) -> np.ndarray:
        self.decode_until(self.pos + n_tokens)
        return self.tokens

    # ------------------------------------------------------------- ckpt
    def checkpoint(self, tag: int = 0) -> str:
        # the image must pair the restored params with the restored cache
        self._finish_lazy_restore()
        return self.session.checkpoint(tag)

    def _boot_template(self, template):
        """Fill missing template subtrees with abstract (meta) skeletons;
        the restored decode cursor sizes the cache."""
        if template["params"] is None:
            template = dict(template, params=self.model.init_abstract())
        if template["cache"] is None:
            if self.tokens is None:
                raise RuntimeError(
                    "cold restore needs the decode_cursor host state in "
                    "the image to size the cache skeleton")
            template = dict(template, cache=self.model.cache_abstract(
                int(self.tokens.shape[0]), self.max_seq))
        return template

    def restore(self, step: Optional[int] = None) -> int:
        """Resume a generation from its image — warm or cold.  A cold
        server (nothing loaded, never started) takes its tree structure
        from the model once the image's host state has replayed the
        decode cursor: no prefill re-execution."""
        template = {"params": self.params, "cache": self.cache}
        engine = self.session.engine
        if self.session.options.restore_mode == "lazy":
            # resume-before-read: params place now, the cache streams
            # behind the server and is joined before the first decode step
            restored = self.session.restore(step=step, wait="critical",
                                            **self._layout())
            self._split_restored()
            template = self._boot_template(template)
            if not covers(self.session.options.critical_states,
                          "serve_state", "params", template["params"]):
                # the critical set leaves params leaves in the stream
                restored = self.session.restore_barrier()
            raw = restored["serve_state"]
            self.params = engine.retree(template["params"], raw["params"])
            if self.session.lazy_pending:
                self._pending_cache_template = template["cache"]
            else:
                self.cache = self._cache_rows(
                    engine.retree(template["cache"], raw["cache"]))
            return self.pos
        if template["params"] is None or template["cache"] is None:
            raw = self.session.restore(step=step,
                                       **self._layout())["serve_state"]
            self._split_restored()
            template = self._boot_template(template)
            self.params = engine.retree(template["params"], raw["params"])
            self.cache = self._cache_rows(
                engine.retree(template["cache"], raw["cache"]))
            return self.pos
        layout = self._layout()
        restored = self.session.restore_into(
            template, state="serve_state", step=step, mesh=layout["mesh"],
            shardings=(layout["shardings"] or {}).get("serve_state"))
        self._split_restored()
        self.params = restored["params"]
        self.cache = self._cache_rows(restored["cache"])
        return self.pos

    def _split_restored(self) -> None:
        """``_split`` for the generation whose decode cursor a restore
        just replayed."""
        if self.ranks is not None and self.tokens is not None:
            self._split(int(self.tokens.shape[0]))

    def release(self) -> None:
        """Drop every reference this server and its engine hold to its
        device state (params, cache, a lazy template), so it is freed at
        once."""
        self.params = self.cache = self._pending_cache_template = None
        self.session.engine.release()

    def _finish_lazy_restore(self) -> None:
        """Join the background stream and adopt the streamed cache."""
        if self._pending_cache_template is None:
            return
        template, self._pending_cache_template = \
            self._pending_cache_template, None
        full = self.session.restore_barrier()
        self.cache = self._cache_rows(self.session.engine.retree(
            template, full["serve_state"]["cache"]))

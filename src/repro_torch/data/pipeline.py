"""Deterministic, checkpointable data pipeline.

The pipeline is a pure function of ``(seed, step, host_id)``, so its entire
runtime state is the tiny cursor dict returned by ``state()`` — exactly what
the CRIUgpu-style engine captures in the unified snapshot (the analogue of
the container's writable-layer/dataset offsets).  Restoring the cursor and
re-reading yields bitwise-identical batches, which is what makes the
engine's deterministic-restore guarantee (§6 of the paper) testable
end-to-end.

Synthetic corpus: a seeded Zipf-ish token stream (structured enough that a
model trained on it shows a falling loss).  Multimodal stubs (audio frames /
vision patches) are generated per the config's frontend-stub contract.

A copy of the JAX package's ``data/pipeline.py`` (numpy only, on the
port's ``ModelConfig``): its batches are bitwise the reference's for every
``(seed, step, host_id)``, so both packages train on the same tokens.
Across the ranks of a process group every rank draws the same global
batch and keeps its rows (:func:`local_rows`): the rows the policy's
data-parallel axes (``dp``; ``("pod", "data")`` in the baseline) give
that rank's device, by its coordinate over them, so the inputs are
bit-equal to the reference's at any mesh shape.  The ranks of one data coordinate (over ``model``) take
the same rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class TokenPipeline:
    cfg: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    step: int = 0

    # ------------------------------------------------------------- state
    def state(self) -> Dict[str, Any]:
        return {"seed": self.seed, "step": self.step,
                "host_id": self.host_id, "num_hosts": self.num_hosts,
                "batch_size": self.batch_size, "seq_len": self.seq_len}

    def restore_state(self, st: Dict[str, Any]) -> None:
        for k, v in st.items():
            setattr(self, k, v)

    # ------------------------------------------------------------- batches
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def peek(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Batch for `step` without advancing the cursor."""
        step = self.step if step is None else step
        rng = self._rng(step)
        cfg = self.cfg
        B, S, V = self.batch_size, self.seq_len, cfg.vocab_size

        # successor stream: next = prev+1 (mod V) with 10% random resets —
        # low-entropy structure a model learns within tens of steps, so the
        # smoke/e2e runs can assert a falling loss.
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        resets = rng.random((B, S)) < 0.1
        rand = rng.integers(0, V, size=(B, S))
        for t in range(1, S):
            nxt = (toks[:, t - 1] + 1) % V
            toks[:, t] = np.where(resets[:, t], rand[:, t], nxt)
        batch: Dict[str, np.ndarray] = {"tokens": toks}

        if cfg.vision_stub:
            P = cfg.num_patches
            batch["vision_embeds"] = rng.normal(
                0, 0.02, size=(B, P, cfg.d_model)).astype(np.float32)
            mask = np.ones((B, S), np.float32)
            mask[:, :min(P, S)] = 0.0
            batch["loss_mask"] = mask
        if cfg.encoder_layers > 0:
            batch["frames"] = rng.normal(
                0, 0.1, size=(B, cfg.num_audio_frames, cfg.d_model)
            ).astype(np.float32)
        return batch

    def next(self) -> Dict[str, np.ndarray]:
        b = self.peek()
        self.step += 1
        return b

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()


def local_rows(batch: Dict[str, np.ndarray], coord: int, size: int
               ) -> Dict[str, np.ndarray]:
    """The rows of a global batch at data coordinate `coord` of `size`:
    the `coord`-th of `size` equal blocks of the batch dim (the block a
    batch sharded over the data-parallel axes puts on the devices of that
    coordinate; ``ProcessMesh.coord`` over the policy's ``dp``)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % size:
            raise ValueError(f"batch of {v.shape[0]} rows does not divide "
                             f"over a data size of {size}")
        n = v.shape[0] // size
        out[k] = v[coord * n:(coord + 1) * n]
    return out

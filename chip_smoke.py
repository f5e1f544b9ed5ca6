#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]      # needs one card

Phase 1 builds the hand-written kernels from the sources in this checkout
(CUDA C++ flash attention and SSD scan, each a tensor-core bf16 source and
a CUDA-core source, through nvcc, one process per source, Triton RMSNorm)
and holds each one against its plain PyTorch version on the card, at the
JAX package's test cases, at the zoo's head dims and at the shapes of the
serving paths, with the tolerances of ``tests/test_kernels.py`` (f32
2e-5, bf16 2e-2; SSD y 2e-4 f32 / 5e-2 bf16, h 1e-4); the tensor-core
kernels must hold HGMMA instructions and repeat bit for bit.  It times the kernel, the
plain version and, where one exists, one PyTorch library call computing
the same function (a yardstick only; the port never calls it) and works
out each kernel's bound: the larger of (bytes moved / 3.35 TB/s) and
(operations / peak rate for their type: 989 TFLOP/s bf16, 67 TFLOP/s
f32), H100 SXM data sheet.  Timings only: flash attention and the SSD
scan at long prompts, both RMSNorm designs at 2048 x 2560 and 2048 x 5120
in turns, and both SSD kernels at mamba2's prefill shape in turns.  Each
kernel is also checked and timed at the shapes of phase 2b (bf16): flash
attention at h2o-danube's prefill (hd 80, the window of 4096 binding at
S = 4608; SDPA under the same mask as the library time), at
qwen3-moe-30b's (hd 128, 32 query heads over 4), at jamba's and at
qwen3-moe-235b's (64 query heads over 4: a GQA group of 16); the SSD
scan at jamba's (nh 128, P 64, N 16); RMSNorm at each path's rows and
widths and at qwen3-moe-235b's q-norm rows (131072 x 128), each
repeated bit for bit; and at the
shapes of phase 2c: flash attention at whisper-tiny's encoder (non-causal
over 1500 frames, a partial last key tile), its prefill cross-attention (4
queries against 1500 keys), its decoder's causal self-attention over the
4-token prompt and qwen2-vl-7b's prefill (a GQA group of 7, hd 128),
RMSNorm at d 384 and 3584; and at the training shapes of phase 10:
flash attention at h2o-danube's B 1 x 4608 under the window, RMSNorm at
its 4608 rows and on qwen3-moe's q/k-norm rows (hd 128).  On a small
input (each serving path's smoke config, f32, with whisper's frames and
qwen2-vl's vision embeddings and image positions) the card's kernel path
must match the CPU plain path to 1e-3.  Last, the dense split over
``model`` (``models/layers.py``): one layer each of phi3-medium-14b and
deepseek-coder-33b (attention and MLP) and qwen3-moe-235b-a22b
(attention with its q/k-norm) at full width, bf16, B 4 x 512, over
|model| 2, 4 and 8: each rank's blocks cut from the whole params by the
port's block arithmetic (``sharding.policy.rank_view``), its partial
output through the kernels, and the f32 sum of the partials held
against the whole layer within 2e-2 of max |out|; flash attention
(beside SDPA) and RMSNorm checked and timed at each per-rank shape the
other cases miss (``[kernels] tp`` lines).

Phase 2 serves each path at full published width with random weights
from ``--seed`` (bf16 compute over f32 masters, kernels on): qwen1.5-0.5b
(KV cache; flash attention + RMSNorm) with a sync and an async snapshot,
then mamba2-2.7b at 8 of its 64 layers, cut for the run's time budget
(SSM cache; SSD scan + RMSNorm) with a sync snapshot.
Each prefills a batch of prompts, decodes greedily, snapshots
mid-generation, and a fresh server cold-restores the image and carries on
token-exact; each image is deleted once checked.  The sync paths write
incremental images: after the first, 16 more tokens and a second image,
which must name the first as parent, write at most the cache plus one
4 MiB chunk per entry and reuse at least the params' bytes; the fresh
server restores the second (following its ref chunks into the first).
The async path's fresh server restores lazily (critical set
serve_state/params, the cache streamed behind and joined at the first
decode step).  Each image's write_s, hash_s (the host's CRCs),
written_bytes and reused_bytes are printed.  The kernels' launch
counters are zeroed just before each path's serving run and read just
after it.  Each path's bf16 kernel logits are then held against its f32
plain path (mamba2's over its first 4 layers), and one prefill and a few
decode steps are profiled.

Phase 2b serves the decoder zoo at its published widths, bf16 compute,
kernels on, each path with one sync image mid-decode that a fresh server
cold-restores and must continue token-exact: h2o-danube-1.8b at 4 of
its 24 layers (cut for the run's time budget) over f32 masters (B 2 x 4608 tokens, max_seq 4672, 48 tokens: the
window binds in prefill, the SWA ring of 4096 wraps in decode),
qwen3-moe-30b-a3b at 2 of 48 layers in bf16 (B 4 x 512, 32 tokens: 128
experts top-8, capacity drops in prefill, dropless decode, q/k-norm),
jamba-v0.1-52b at 8 of 32 layers (one period: 7 Mamba, 1 attention, 4 MoE)
in bf16 (B 2 x 1024, 32 tokens: KV and SSM caches in one image) and
qwen3-moe-235b-a22b at 1 of its 94 layers in bf16 (d 4096, 64/4 heads x
128, 128 experts top-8 x 1536, vocab 151936: 3.73 B params, a 7.5 GB
image; B 4 x 512, 32 tokens; the MoE's expert-parallel body at one
model rank, all 128 experts local, C = 160 in prefill); each
path runs in a child process, waited for, that hands its launches back
(forked from a server process that imported torch once, so no child pays
the import again), so its pinned host buffers are gone before the next
path, and its image is deleted after it.  Flash attention and, for
jamba, the SSD scan must run on the tensor-core kernels alone; the kernel
path's forward logits over every position must be no further from the
f32 plain path, on average, than LOGIT_SLACK times the bf16 plain path's
(danube at 4 layers of the full-width params, qwen3 at its 2).

Phase 2c serves the encoder-decoder and the VLM at their published
widths, bf16 compute, kernels on, each in a process of its own as in
phase 2b: whisper-tiny uncut over f32 masters (B 16 x 1500 frames, the
4-token start-of-transcript prompt, max_seq 448, 96 tokens: a sync image
at token 48, an incremental image 24 tokens later that must write the
self cache alone, every param and cross_k / cross_v entry staying in the
first image) and qwen2-vl-7b at 4 of its 28 layers (cut for the
run's time budget) in bf16 (B 2 x
1280: one 32 x 32 image of 1024 vision embeddings with its M-RoPE
positions, then 256 text tokens; max_seq 1344, 32 tokens, one sync
image).  A fresh
server cold-restores each image and must decode the same tokens; flash
attention must run on the tensor-core kernel alone, RMSNorm must run; the
logit check of phase 2b follows (qwen2-vl at 4 layers).

Phase 1 also holds each kernel's autograd Function (kernel forward,
oracle backward) against plain autograd through its oracle on the card,
for the reference's sum-of-squares loss (each path's forward output feeds
its backward): at the reference's grad cases in f32 with its tolerances,
and at the slice shapes and the zoo's training shapes (flash attention
at danube's window over 4608 tokens, at qwen3-moe's GQA 32/4,
qwen2-vl's 28/4, phi3-medium's 40/10 and deepseek-coder's 56/8; RMSNorm
on qwen3-moe's q/k-norm rows and on phi3-medium's and deepseek-coder's
2048 x 5120 and 2048 x 7168 block norm rows) in bf16 and f32
(rtol 2e-2 bf16; f32 2e-4 attention, 1e-3 SSD, 1e-5 RMSNorm; atol the
same times each input's largest |grad|); each forward must launch its
kernel once.

Phase 3 trains qwen1.5-0.5b at full width, cut to 2 of its 24 layers for
the run's time budget (bf16 over f32 masters, kernels,
remat, batch 4 x 512, AdamW, deterministic settings): (a) 12 steps with an
async image every 4; (b) a run that crashes at step 7 and restores from
its step-4 sync image must give (a)'s losses of steps 5-12 and final
params and optimizer state bitwise; (c) fresh trainers cold-restore (a)'s
async and (b)'s sync step-12 images, bitwise equal; (d) the loss falls:
step 0's batch scores lower after (a) than before by more than (a)'s 12
batches' scores spread before training (the steps' own losses, each on a
new batch, move within that spread); (e) flash attention and RMSNorm
launch 2 x L and 2 x 2 x L + 1 times per executed step, L layers
(forward and remat recompute).  Phase 3b trains mamba2-2.7b at full width cut to 4 of
its 64 layers (batch 2 x 512, 3 steps): a finite loss, 2 x 4 SSD launches
per step, and first-step grads of the mamba leaves within MAMBA_GRAD_TOL
of the plain bf16 path's, where a witness (the SSD kernel's rounding in
plain torch) must fit too and two broken SSD forwards (y 2% off, no
carry between chunks) must not.
In phase 3 (b)'s restore from the step-4 image is lazy (critical
train_state/params; restore_critical_s is printed against (c)'s eager
cold restores).  (e) trains (a)'s run again with capture="concurrent"
(a soft-freeze capture every 4 steps): its losses must be (a)'s bitwise,
and a fresh trainer restores its first image (whose host state names the
step at the validate pause), runs to step 12 and must end at (a)'s
params, m and v bitwise; the pin and validate pauses, speculation time
and dirty / re-captured entries and bytes are printed.
Phase 4 drives the session API under capture="concurrent" with 2 GiB of
CUDA tensors (f32 and bf16): while the speculation's copies run, half the
leaves are mutated in place on the compute stream (add_, a write by index
into a view), one is replaced, one key added and one dropped; the dirty
set must be exactly the touched keys, the re-captured bytes at most
theirs, and the image must restore bitwise to the live tree.
Phase 5 replicates and migrates, qwen1.5-0.5b at full width through the
kernels, (a)-(c) at 2 of its 24 layers (cut for the run's time budget):
(a) sync incremental images 16 tokens apart, each pushed inside
the dump to a peer by the CAS delta replicator (image 2 must ship the KV
cache, at most one chunk more, and skip image 1 whole); the primary's
images are deleted and a fresh server must restore from the replica
(``restored_from_replica``) and continue token-exact; (b) one stored
chunk of a KV-cache entry of the primary image is torn: a lazy restore
without a replicator must raise at the barrier, one with the replicator
must heal the stream from the replica and continue token-exact; (c) an
async incremental server migrates live by pre-copy (a round every 4
tokens, the controller of ``TransferPolicy(mode="delta",
precopy_rounds=4)`` deciding, then a checkpoint-on-signal and the
residual round), and a fresh server at the destination must continue
token-exact; one full push of the final image to an empty peer is the
stop-and-copy baseline.  (d) Training, cut to 4 of the 24 layers: a run
of 10 steps, and a run migrated by pre-copy (a round every 2 steps) whose
destination resumes and runs to step 10: losses, params, m and v must be
the first run's bitwise; before that, the source's images are deleted and
a fresh trainer there must restore from the destination as its replica,
bitwise.  Each round's bytes sent and
reused, its wall time and the decision, the blackout (the residual
push) and every replicate_s are printed as ``[replicate]`` and
``[migrate]`` lines.
Phase 6 drives the orchestrator, the interception baseline and the serving
fleet (``repro_torch.orchestrator``, ``repro_torch.baselines``) on
qwen1.5-0.5b at full width (bf16 over f32 masters, kernels, remat; phase
3's training shape, phase 2's serving shape), cut to 2 of its 24 layers
for the run's time budget but in (d), which keeps all 24, in a child
process (alone: ``--orch``): (a) preemption on one device slot: ``lo`` is
mid-run when ``hi`` arrives, checkpoints on the signal and is evicted;
device memory at the eviction must fall by lo's params + AdamW state (its
grads are freed at each step's end) and from lo's peak by params + AdamW +
grads; hi runs to done, lo restores and finishes, and each job's digest
must equal an uninterrupted run's; (b) a serving job crashes at token 4,
the heartbeat detects it, and it restores from its newest image
token-exact; (c) a serving job migrates live by pre-copy between 2 hosts
and is token-exact at the destination; (d) one training run is imaged by
the engine and logged by ``InterceptionCheckpointer`` (the step wrapped,
AdamW in place) at 4 and 16 steps: replay must reproduce the engine's
restore (and at 16 the live state) bitwise; replay's whole restore must
grow with the log (by over half the 12 extra steps' bare time) and the
engine's (the faster of two restores of each image, taken in turns) must
move by under half that growth, either way; then the MLP ``intercept``
scenario runs to done; (e) one serving image fans out to 4 replicas over 2
hosts with lazy boots: every replica token-exact against the solo server,
a host's second replica shipping under 5% of its first's bytes, and a
trace that scales up and drains. The heartbeat deadlines are 1.0 s
(training) and 0.25 s (serving), for full-width slices; each part's
recovery breakdown, goodput, rounds, restore times, TTFTs and bytes are
printed as ``[orch]`` lines. The launch counters are zeroed just before
each part's own run (the scenario, the logged training run, the fleet) and
read just after it, before the reference runs, replays and timed turns
that check it.
Phase 7 drives the chaos campaigns, the observability plane and the CLI
(``repro_torch.chaos``, ``repro_torch.obs``, ``repro_torch.cli``) in a
child process (alone: ``--chaos``), started once phase 1 is done and run
beside phases 2-2c (its sim is host work; its times are taken under their
load), calling ``repro_torch.cli.main`` in that process: (a) ``chaos-campaign RUN --jobs 100 --hosts 20 --seed 0
--faults all=1 --capture sweep`` on the card (each sim job's state 2048
float64 on it): exit 0, the invariant held in both modes, every planned
fault injected (11 classes sync, 12 concurrent), each ``dirty_burst`` a
flipped byte of a CUDA tensor whose dump re-captured it, every recovered
job's digest its unfaulted replay on the card; (b) the sync campaign on
the CPU must give the card's rows and per-job outcomes; (c) seed 21
twice gives one fingerprint on the card, seed 22 another; (d) ``trace
--chrome``, ``events --class fault`` (one row per injection),
``metrics --json`` (``chaos.injections`` the injected count) and
``validate_journal`` on (a)'s sync journal; (e) ``inspect`` and
``verify`` exit 0 on a job image of (a), ``verify`` exits 1 once a pack
is torn, ``check --device cuda`` exits 0, and a frozen capture on the
card carries the leftover-device-bytes warning.  The sim runs no kernel:
the counters stay at 0 over (a).  ``[chaos]`` and ``[cli]`` lines carry
each mode's wall_s, ticks and per-class injected / recovered / healed /
quarantined / MTTR.
Phase 8 drives meshes, elastic restore and the launchers
(``repro_torch.launch``, ``repro_torch.runtime.elastic``; alone:
``--launch``), each launcher run and each half of (c) in a process of its
own (forked from the fork server), its kernels' counters zeroed just
before its run: (a) ``python -m repro_torch.launch.train``'s ``main``
trains whisper-tiny at full width, uncut (``--steps 8 --ckpt-every 4``,
B 8 x 1500 frames, bf16 over f32 masters, kernels): uninterrupted, then
``--fail-at 6`` (exit 1), then ``--restore`` (step 4), whose final loss
must be the uninterrupted one bitwise; (b) ``repro_torch.launch.serve``
serves qwen1.5-0.5b at full width (B 4 x 512, ``--max-seq 1024
--tokens 32``): uninterrupted, with ``--snapshot-at 16``, then
``--restore``, whose tokens must be the uninterrupted run's; (c)
qwen1.5-0.5b at full width, cut to 1 of its 24 layers for the run's
time budget, trains at phase 3's shape on a (4, 2)
``("data", "model")`` mesh of card slots with a sync image at step 3,
then step 4, whose state it saves raw; another process restores the
image with ``elastic_restore`` onto (4, 2) ("identical"), then onto
(2, 2) and (1, 1) ("resharded"), each bit-equal to the first, and one
step from each restored state must equal the uninterrupted step 4
bitwise; the image's block count and bytes (the state's bytes, as
unsharded) and each restore's time are printed.  Flash attention (tc alone) and
RMSNorm must launch in every run.  ``[launch]`` lines carry the numbers.
Phase 9 drives the dry run and its op analysis (``repro_torch.launch.
dryrun``, ``repro_torch.launch.hlo_analysis``; alone: ``--dryrun``): (a)
``python -m repro_torch.launch.dryrun`` in one process (no card: every
slot on the meta device) traces one decode cell of every arch at its
full published config on the (16, 16) pod mesh and qwen1.5-0.5b's
``train_4k`` cell on the (2, 16, 16) multipod mesh; the script starts it
first, beside phases 1-8 (with ``--dryrun``: beside (b) and (c)), and
phase 9 waits for it and prints each summary.  (b) and (c) run in a
child process of its own.  (b) qwen1.5-0.5b uncut, at phase 3's training
shape (4 x 512, remat) on a (1, 1) mesh: the dry run's
``argument_size_in_bytes`` must equal, to the byte, a real ``Trainer``'s
params, AdamW state and batch on the card; its modelled peak (arguments
+ temp) must lie within 0.5-2x of ``torch.cuda.max_memory_allocated()``
over one real step (kernels on); the analyzer's FLOPs over one real step
with ``use_kernels=False`` on the card must equal the meta trace's; the
step's time with the kernels (flash (tc) and RMSNorm) is printed beside
``roofline_bound_s`` as a measured roofline fraction.  (c) The same for
the prefill (4 x 512) and one decode step over a cache of 1024.
``[dryrun]`` lines carry the numbers.

Step time, tokens/s, MFU, snapshot and restore times, a profile of one
step and the script's wall time are printed beside the card's name and
power limit; the ``[time]`` marks count from the process's start, as a
limit on the command's time does.

Phase 10 trains the decoder zoo at published widths (bf16 over f32
masters, kernels, remat, AdamW, deterministic settings; alone:
``--train-zoo``; one arch alone: ``--path train-zoo/ARCH``), each arch
in a child process of its own, the whole phase beside phases 8, 9 and 11
(which run their work in children of their own; the times of each are
taken under the others' load):
qwen3-moe-30b-a3b at 1 of its 48 layers (B 4 x 512; 128 experts top-8,
capacity drops, q/k-norm through the RMSNorm kernel), h2o-danube-1.8b
at 2 of 24 (B 1 x 4608: the 4096 window binds) and deepseek-coder-33b
at 1 of 62 (B 4 x 512; a GQA group of 7, d 7168, an untied head), each
(a) 6 steps uninterrupted and (b) through ``run_with_restarts`` with a
sync image at step 3, a crash at step 5 and a cold restore from the
image: (b)'s losses of steps 4-6, final params and AdamW state must be
(a)'s bitwise; qwen2-vl-7b at 1 of 28 (B 2 x 1280: 1024 vision
embeddings and 256 text tokens, M-RoPE) and phi3-medium-14b at 2 of 40
(B 4 x 512; an untied 100352-row head) twice for 3 steps from one seed,
bitwise equal.  For
each, step 0's batch must score lower after (a) than before by more than
the run's batches' spread, the aux loss must be finite at every step (>
0 with MoE, 0 without), flash attention (tc alone) and RMSNorm must launch 2 x L and
2 x (2 + 2 q/k) x L + 1 times per executed step, and the first step's
grads in f32 on the kernel path must lie within the arch's tolerance of
the plain f32 path's (worst leaf, max |diff| / max |grad|) where a
witness whose attention forward is 2% off must not (bf16's, against the
plain bf16 path, are printed beside them: ill-conditioned, see
ZOO_TRAIN).  Step time, tokens/s and
MFU (active params: 8 of 128 experts, no embedding gather; the window's
visible pairs), the image's write, the restore and the host's free
memory around them are printed as ``[train-zoo]`` lines.  Then the four
examples of ``examples/torch/`` run in one child process with
``device="cuda"`` (their smoke configs, the plain path), each asserting
what its JAX counterpart asserts; ``[examples]`` lines carry what they
print.

Phase 11 runs the train and serve launchers over every card of the host,
one process per card (``repro_torch.launch.dist``, N =
``torch.cuda.device_count()`` ranks; alone: ``--dist``), qwen1.5-0.5b at
full width and 1 of its 24 layers, global batch 4 x 512 (N x 512 when N
does not divide 4): (a) 12 steps with sync images every 4 (and a
just-in-time one wherever the straggler monitor flags a step); (b) from
(a)'s step-4 image, the last rank SIGKILLed after its step-8 pack and
before its ``PREPARED`` marker (a fault on the chaos hook plane): no
step-8 manifest, the other ranks out within the barrier's deadline, and
``--restore`` from step 4 must reach (a)'s final loss bitwise and (a)'s
step-12 entries CRC for CRC; (c) two CPU ranks (gloo), beside (b),
write a smoke image and then restore (a)'s image, and the card's ranks
restore theirs, every leaf's block bit-equal (with N >= 2, (a)'s image
on one rank too); (d) the serve launcher, a snapshot at token 8 resumed
token-exact by ``--restore``; (e) the engine's modes across the ranks,
through the train launcher's rank with the caller's options: (e1) 12
steps with soft-freeze captures every 4 steps (``capture="concurrent"``,
incremental images, replicated to a peer directory in copy mode), losses
bitwise (a)'s; (e2) with (e1)'s run directory deleted (and the replica's
images whose validate pause came at step 12), a lazy ``--restore`` pulls
the replica's newest and runs to step 12: (a)'s losses bitwise and (a)'s
step-12 entries CRC for CRC.  ``[dist]`` lines give each rank's step
time, pack bytes and commit barrier wait, and (e)'s pauses, bytes, push
and restore times; (a)'s names the process mesh (``data`` = N, ``model``
= 1, as the reference's launchers lay their devices); on one card a line
says that more than one rank, and a model axis above 1 (the
expert-parallel MoE on a (2, 2) mesh), were held only by the CPU tests.

``--launch --out F`` runs phase 8 alone, ``--dryrun --out F`` phase 9,
``--train-zoo --out F`` phase 10, ``--dist --out F`` phase 11 (``--path
dist``: at ``--layers``).  ``--path ARCH --out F`` serves one
path alone, as the script serves it (``--path orch``: phase 6, ``--path
repl``: phase 5 (a)-(c), ``--path elastic``: phase 8 (c), ``--path
train``: phase 3's qwen1.5 training, ``--path train-zoo/ARCH``: phase
10's training of one arch; ``--layers N``: at N layers;
``tools/cut_ab.py`` times such a depth cut against the path's own depth,
in turns, and a path run beside another against the two run in turn).

Every phase must pass; the script exits non-zero otherwise, and at once
(printing no result) when no CUDA device is present or the package is not
beside it.  The last line is the device summary.
"""
import os

# before torch is imported: cuBLAS picks its workspace at initialisation,
# and bitwise resume needs the deterministic one
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import argparse
import contextlib
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}

# (B, Sq, Sk, H, KV, hd, causal, window): tests/test_kernels.py:22-29
ATTN_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 8, 2, 64, True, 0),
    (1, 192, 192, 4, 2, 32, True, 64),
    (2, 64, 160, 4, 4, 64, False, 0),
    (1, 100, 100, 2, 1, 16, True, 0),
    (2, 256, 256, 40, 10, 128, True, 0),     # phi3-medium's heads, hd 128
    (1, 192, 192, 32, 8, 80, True, 64),      # h2o-danube's hd 80, window
]
ATTN_SLICE = (4, 512, 512, 16, 16, 64, True, 0)   # qwen1.5-0.5b prefill
# timing only: phi3-medium's attention at a 4096-token prompt, bounded by
# operations (172 GFLOP against 105 MB)
ATTN_LONG = (1, 4096, 4096, 40, 10, 128, True, 0)
NORM_SLICE = (2048, 1024)                          # prefill rows x d_model
NORM_DESIGN_SHAPE = (2048, 5120)                   # mamba2's gated norm
# both RMSNorm designs, timed in turns: mamba2's block and gated norms,
# and deepseek-coder-33b's prefill rows (d 7168: wider than SPLIT_MAX_D,
# and 29.4 MB, more than half of L2, so the module takes "split")
NORM_DESIGN_SHAPES = [(2048, 2560), NORM_DESIGN_SHAPE, (2048, 7168)]
# qwen1.5 block norms (prefill, decode), odd widths, then mamba2's block
# norms (d_model 2560) and gated norms (d_inner 5120)
NORM_CASES = [(2048, 1024), (4, 1024), (21, 96), (1, 384), (130, 384),
              (2048, 2560), (4, 2560), (2048, 5120), (4, 5120)]
# (B, S, nh, P, N, chunk): tests/test_kernels.py:70-74, then the mamba2
# smoke config's prefill (a partial last chunk) and jamba's (P, N)
SSD_CASES = [
    (1, 64, 2, 16, 32, 16),
    (2, 100, 3, 32, 64, 32),
    (1, 128, 1, 64, 128, 128),
    (2, 12, 8, 16, 16, 8),
    (1, 40, 2, 64, 16, 128),
]
SSD_SLICE = (4, 512, 80, 64, 128, 128)             # mamba2-2.7b prefill
# timing only: mamba2's scan at a 4096-token prompt (32 chunks)
SSD_LONG = (1, 4096, 80, 64, 128, 128)
# (shape, plain chunk, kernel chunks): tests/test_kernels.py:92-107 on the
# CUDA-core kernel (f32), then the tensor-core kernel's tiles 64 and 128
SSD_INVARIANCE = [((1, 96, 2, 16, 32), 96, (16, 32, 48), "torch.float32"),
                  ((1, 160, 2, 64, 32), 160, (32, 64, 128),
                   "torch.bfloat16")]
SSD_TOL = {"torch.float32": 2e-4, "torch.bfloat16": 5e-2}
SSD_H_TOL = 1e-4
# the decoder zoo's serving shapes (bf16, phase 2b): flash attention at
# h2o-danube's prefill (hd 80, the window of 4096 binding at S = 4608),
# qwen3-moe-30b's (hd 128, 32 query heads over 4), jamba's,
# qwen3-moe-235b's (64 query heads over 4: a GQA group of 16),
# phi3-medium-14b's (40 over 10: a group of 4) and deepseek-coder-33b's
# (56 over 8: a group of 7); the SSD scan at jamba's (nh 128, P 64, N
# 16); RMSNorm at each path's prefill rows x d_model, qwen3-moe's and
# jamba's decode rows (the one-row design; danube's (2, 2560) is that of
# (4, 2560) above), jamba's gated norm (d_inner 8192) at prefill and
# decode, qwen3-moe-235b's q-norm rows (4 x 512 tokens x 64 heads, hd
# 128; its k-norm rows, 8192 x 128, are TRAIN_NORM's) and
# deepseek-coder-33b's rows at prefill and decode (d 7168; phi3-medium's
# d 5120 rows are NORM_CASES')
ZOO_ATTN = [(2, 4608, 4608, 32, 8, 80, True, 4096),
            (4, 512, 512, 32, 4, 128, True, 0),
            (2, 1024, 1024, 32, 8, 128, True, 0),
            (4, 512, 512, 64, 4, 128, True, 0),
            (4, 512, 512, 40, 10, 128, True, 0),
            (4, 512, 512, 56, 8, 128, True, 0)]
ZOO_SSD = [(2, 1024, 128, 64, 16, 128)]
ZOO_NORM = [(9216, 2560), (2048, 2048), (2048, 4096), (2048, 8192),
            (4, 2048), (2, 4096), (2, 8192), (131072, 128), (2048, 7168),
            (4, 7168)]
# the shapes of phase 2c (bf16): flash attention at whisper-tiny's encoder
# (non-causal over 1500 frames, not a multiple of the key tile), at its
# prefill cross-attention (4 prompt tokens against 1500 frames: one query
# tile, 124 of its rows padding), at its decoder's causal self-attention
# over the 4-token prompt (one 4 x 4 causal tile: 124 query rows and every
# key past 4 padding) and at qwen2-vl-7b's prefill (28 query heads over 4:
# a GQA group of 7); RMSNorm at whisper's encoder, prefill and decode rows
# (d 384) and at qwen2-vl's prefill and decode rows (d 3584)
MM_ATTN = [(16, 1500, 1500, 6, 6, 64, False, 0),
           (16, 4, 1500, 6, 6, 64, False, 0),
           (16, 4, 4, 6, 6, 64, True, 0),
           (2, 1280, 1280, 28, 4, 128, True, 0)]
MM_NORM = [(24000, 384), (64, 384), (16, 384), (2560, 3584), (2, 3584)]
# the training shapes of phase 10 (bf16) that phases 2b-2c do not cover:
# flash attention at h2o-danube's B 1 x 4608 under the window; RMSNorm at
# danube's 4608 rows x 2560 and on qwen3-moe's q/k-norm rows (one per
# token and head, hd 128: 4 x 512 x 32 queries, 4 x 512 x 4 keys).
# qwen3-moe's, phi3-medium-14b's and deepseek-coder-33b's attention (B 4
# x 512 at 32/4, 40/10 and 56/8 heads) are ZOO_ATTN's, qwen2-vl's
# MM_ATTN's; phi3-medium's block norm rows (2048 x 5120) are NORM_CASES',
# deepseek-coder's (2048 x 7168) ZOO_NORM's
TRAIN_ATTN = [(1, 4608, 4608, 32, 8, 80, True, 4096)]
TRAIN_NORM = [(4608, 2560), (65536, 128), (8192, 128)]
# phase 1's tensor-parallel check (models/layers.py): one layer each at
# full width, bf16, B 4 x 512 -- phi3-medium-14b's attention (40 / 10
# heads x 128) and MLP (d_ff 17920), deepseek-coder-33b's (56 / 8, d_ff
# 19200) and qwen3-moe-235b-a22b's attention (64 / 4, q/k-norm) -- cut
# over every |model| of TP_MODEL that splits its heads, each rank's
# partial held in sum against the whole layer; (arch, with its MLP)
TP_ARCHS = (("phi3-medium-14b", True), ("deepseek-coder-33b", True),
            ("qwen3-moe-235b-a22b", False))
TP_MODEL = (2, 4, 8)
TP_BATCH = (4, 512)


def log(*a):
    print(*a, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``): the
    interpreter's start and the imports included, as a time limit on the
    command sees them."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device time of one fn() call in ms: CUDA events around `iters`
    back-to-back calls, queued behind a spin kernel so the host's launch
    overhead is not counted; median of `reps` such windows."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)      # ~25 ms: the queue fills meanwhile
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[len(times) // 2]


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phase 1
def attention_case(case, dtype, gen, timing_only: bool = False):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KV, hd, causal, window = case
    dev = "cuda"
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    run = lambda: fa.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                     window=window)
    out = run()
    torch.cuda.synchronize()
    # one owner per output element, no atomics: bitwise the same again
    ok = bool(torch.isfinite(out.float()).all()) and torch.equal(out, run())
    visible = int(fa._visible(Sq, Sk, causal, window, dev).sum())
    flops = 4.0 * B * H * hd * visible
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, flops, dtype)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window or (causal and Sq != Sk):
        mask = fa._visible(Sq, Sk, causal, window, dev)
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=H != KV)

    def lib():
        # the yardstick at its fastest: deterministic mode (which the
        # serving phase needs) steers SDPA to a slower backend
        torch.use_deterministic_algorithms(False)
        try:
            return sdpa()
        finally:
            torch.use_deterministic_algorithms(True)
    if timing_only:     # the plain version would not fit: SDPA instead
        want, plain_ms = lib().transpose(1, 2), None
    else:
        want = fa.attention_plain(q, k, v, causal=causal, window=window)
        plain_ms = cuda_ms(lambda: fa.attention_plain(
            q, k, v, causal=causal, window=window))
        ok = ok and (out.float() - want.float()).abs().max().item() <= \
            TOL[str(dtype)]
    ms = cuda_ms(run)
    return {
        "ok": ok, "variant": fa.variant(dtype, hd),
        "max_abs_err": (out.float() - want.float()).abs().max().item(),
        "ms": ms, "plain_ms": plain_ms, "library_ms": cuda_ms(lib),
        "bound_ms": b_ms, "bound_by": b_by, "tflops": flops / ms / 1e9,
    }


def rmsnorm_designs(gen) -> dict:
    """Both RMSNorm designs at NORM_DESIGN_SHAPES (bf16), timed in turns;
    {shape: {design: {"ms": [first, second], "ok": bool}}}."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    out = {}
    for rows, d in NORM_DESIGN_SHAPES:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        s = torch.randn(d, generator=gen, device="cuda")
        want = rn.rmsnorm_plain(x, s)
        times = {name: [] for name in rn.DESIGNS}
        for name in rn.DESIGNS + rn.DESIGNS[::-1]:
            times[name].append(cuda_ms(lambda: rn.rmsnorm(x, s,
                                                          design=name)))
        res = out[f"{rows}x{d}"] = {}
        for name in rn.DESIGNS:
            got = rn.rmsnorm(x, s, design=name)
            res[name] = {"ms": times[name], "ok": got.dtype == x.dtype
                         and _close(got, want, 2e-2)}
    return out


def rmsnorm_case(shape, dtype, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    rows, d = shape
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    s = torch.randn(d, generator=gen, device="cuda")
    out = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    want = rn.rmsnorm_plain(x, s)
    err = (out.float() - want.float()).abs().max().item()
    # the criterion of tests/test_kernels.py:14-16 (rtol = atol): at
    # d = 5120, |y| reaches ~20, where one bf16 step is 0.125
    ok = out.dtype == x.dtype and _close(out, want, TOL[str(dtype)])
    # one program per row block, no atomics: bitwise the same again
    ok = ok and torch.equal(out, rn.rmsnorm(x, s))
    nbytes = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
    b_ms, b_by = bound(nbytes, 4.0 * x.numel(), torch.float32)
    sx = s.to(dtype)
    return {
        "ok": ok, "max_abs_err": err, "variant": rn.design_for(x),
        "ms": cuda_ms(lambda: rn.rmsnorm(x, s)),
        "plain_ms": cuda_ms(lambda: rn.rmsnorm_plain(x, s)),
        "library_ms": cuda_ms(lambda: F.rms_norm(x, (d,), sx, eps=1e-5)),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def _close(got, want, tol: float, atol: float = None) -> bool:
    """Finite, and |got - want| <= atol + tol·|want| everywhere (the
    tests' assert_allclose with rtol = tol, atol = tol unless given)."""
    import torch
    got, want = got.float(), want.float()
    atol = tol if atol is None else atol
    return bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= atol + tol * want.abs()).all())


def ssd_inputs(shape, dtype, gen):
    import torch
    import torch.nn.functional as F
    B, S, nh, P, N = shape
    dev = "cuda"
    x = torch.randn(B, S, nh, P, generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn(B, S, nh, generator=gen, device=dev))
    A = -torch.exp(0.3 * torch.randn(nh, generator=gen, device=dev))
    Bm = torch.randn(B, S, N, generator=gen, device=dev).to(dtype)
    Cm = torch.randn(B, S, N, generator=gen, device=dev).to(dtype)
    return x, dt, A, Bm, Cm


def ssd_flops(B, S, nh, P, N) -> float:
    """Operations SSD needs on this input, whatever tile a kernel uses:
    the fewer of the per-step recurrence (h·decay + dt·x⊗B, then C·h:
    5·N·P per head) and the chunked form at the chunk length T that
    minimises it.  Per step of a T-step chunk, causal halves only: C·Bᵀ
    (T+1)·N, shared by the heads, and per head G·x (T+1)·P, C·hᵀ and
    xᵀ·W 2·N·P each, and the state's decay N·P/T."""
    chunked = min((T + 1) * N + nh * ((T + 1) * P + 4 * N * P + N * P / T)
                  for T in range(1, S + 1))
    return float(B * S * min(chunked, 5 * nh * N * P))


def ssd_case(case, dtype, gen, timing_only: bool = False):
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    B, S, nh, P, N, chunk = case
    args = ssd_inputs((B, S, nh, P, N), dtype, gen)
    y, h = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    y2, h2 = ssd.ssd_scan(*args, chunk=chunk)
    y_p, h_p = ssd.ssd_plain(*args, chunk=chunk)
    # one owner per output element and state, no atomics: the same bits
    ok = torch.equal(y, y2) and torch.equal(h, h2)
    if not timing_only:
        ok = ok and (y.dtype == dtype and h.dtype == torch.float32
                     and _close(y, y_p, SSD_TOL[str(dtype)])
                     and _close(h, h_p, SSD_H_TOL))
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y, h))
    flops = ssd_flops(B, S, nh, P, N)
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {
        "ok": ok, "variant": ssd.variant(dtype, P, N),
        "max_abs_err": (y.float() - y_p.float()).abs().max().item(),
        "h_max_abs_err": (h - h_p).abs().max().item(),
        "y_max_abs": y_p.float().abs().max().item(),
        "ms": cuda_ms(lambda: ssd.ssd_scan(*args, chunk=chunk)),
        "plain_ms": cuda_ms(lambda: ssd.ssd_plain(*args, chunk=chunk)),
        "library_ms": None,          # no single PyTorch call computes SSD
        "bound_ms": b_ms, "bound_by": b_by,
        # the same work at the f32 peak, the bound of the f32 FMA kernel
        "bound_f32_peak_ms": bound(nbytes, flops, torch.float32)[0],
    }


def ssd_passes(gen) -> dict:
    """torch.profiler over a few SSD calls at mamba2's prefill shape (bf16,
    the tensor-core kernel): device ms of each of its launches."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    B, S, nh, P, N, chunk = SSD_SLICE
    args = ssd_inputs((B, S, nh, P, N), torch.bfloat16, gen)
    ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ssd.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            m = re.search(r"::(\w+(<[^>]*>)?)", e.key)
            out[m.group(1) if m else e.key[:60]] = (
                e.self_device_time_total / e.count / 1e3)
    return out


def ssd_variants_in_turns(gen) -> dict:
    """Both SSD kernels on the same bf16 inputs at mamba2's prefill shape,
    timed in turns (fma, tc, tc, fma); {variant: [ms, ms]}."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    B, S, nh, P, N, chunk = SSD_SLICE
    args = ssd_inputs((B, S, nh, P, N), torch.bfloat16, gen)
    times = {"tc": [], "fma": []}
    for kind in ("fma", "tc", "tc", "fma"):
        times[kind].append(cuda_ms(lambda: ssd.ssd_scan(*args, chunk=chunk,
                                                        kind=kind)))
    return times


def ssd_chunk_invariance(gen) -> list:
    """Each kernel at several chunks against the plain version at one."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    failed = []
    for shape, ref_chunk, chunks, dtype in SSD_INVARIANCE:
        args = ssd_inputs(shape, getattr(torch, dtype[6:]), gen)
        y0, h0 = ssd.ssd_plain(*args, chunk=ref_chunk)
        tol = 2e-4 if dtype == "torch.float32" else SSD_TOL[dtype]
        h_tol = 2e-4 if dtype == "torch.float32" else SSD_H_TOL
        kind = ssd.variant(args[0].dtype, shape[3], shape[4])
        for c in chunks:
            y, h = ssd.ssd_scan(*args, chunk=c)
            ok = _close(y, y0, tol) and _close(h, h0, h_tol)
            log(f"[kernels] ssd_scan ({kind}) chunk {c} vs plain chunk "
                f"{ref_chunk} {shape} {dtype}: ok={ok} err="
                f"{(y.float() - y0.float()).abs().max().item():.3g}")
            if not ok:
                failed.append(("ssd_scan", kind, "chunk", c))
    return failed


def path_shape_cases(rows: dict, gen) -> list:
    """Each kernel checked and timed (bf16) at the shapes of the zoo
    (phase 2b), of the encoder-decoder and VLM paths (phase 2c) and of
    the zoo's training (phase 10), into rows["zoo"], rows["mm"] and
    rows["train"]; the cases that failed."""
    import torch
    failed = []
    for group, attn, ssd, norm in (("zoo", ZOO_ATTN, ZOO_SSD, ZOO_NORM),
                                   ("mm", MM_ATTN, [], MM_NORM),
                                   ("train", TRAIN_ATTN, [], TRAIN_NORM)):
        rows[group] = {}
        for name, cases, case_fn in (
                ("flash_attention", attn, attention_case),
                ("ssd_scan", ssd, ssd_case),
                ("rmsnorm", norm, rmsnorm_case)):
            rows[group][name] = []
            for case in cases:
                r = case_fn(case, torch.bfloat16, gen)
                variant = r["variant"]
                lib = r["library_ms"]
                log(f"[kernels] {name} ({variant}) {group} {case} bf16: "
                    f"ok={r['ok']} err={r['max_abs_err']:.3g} "
                    f"ms={r['ms']:.5f} plain={r['plain_ms']:.4f} library="
                    f"{'none' if lib is None else f'{lib:.5f}'} "
                    f"bound={r['bound_ms']:.5f} ({r['bound_by']})")
                if not r["ok"]:
                    failed.append((name, case, "bf16"))
                rows[group][name].append(dict(case=list(case),
                                              variant=variant,
                                              **{k: r[k] for k in TIMES}))
    return failed


def tp_layer_check(cfg, with_mlp: bool, seed: int, gen) -> tuple:
    """One layer of `cfg` (bf16 over f32 masters, the kernels on) split over each |model| of TP_MODEL that cuts its heads:
    every rank's view cut from the whole params by the port's block
    arithmetic (``sharding.policy.rank_view``), its attention (and MLP)
    run through the kernels up to the row-parallel output, and the f32
    sum of the ranks' partials -- the all-reduce's arithmetic -- held
    against the whole layer within 2e-2 of its max |out|.  Returns (the
    log rows, the flash and RMSNorm shapes a rank ran, the failures)."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.lm import LM
    from repro_torch.sharding.policy import rank_view
    arch = cfg.name
    B, S = TP_BATCH
    model = LM(cfg, compute_dtype=torch.bfloat16, remat=False,
               use_kernels=True, device="cuda")
    specs = {"attn": L.attention_specs(cfg)}
    if with_mlp:
        specs["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff)
    params = L.init_params(specs, seed, torch.float32, "cuda")
    logical = L.axes_tree(specs)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda").to(
        torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S)
    blocks = {"attn": lambda p, tp: model._attn_partial(p, 0, x, pos,
                                                        tp=tp)[0]}
    if with_mlp:
        blocks["mlp"] = lambda p, tp: L.mlp(p["mlp"], x)
    whole = {k: f(params, None) for k, f in blocks.items()}
    rows, shapes, failed = [], set(), []
    for m in TP_MODEL:
        mesh = make_host_mesh(data=1, model=m, device="cuda")
        views = [rank_view(params, logical, mesh, r, L.tp_units(cfg))
                 for r in range(m)]
        if views[0][0] is None or views[0][0].heads is None:
            log(f"[kernels] tp {arch} |model| {m}: heads not split, "
                f"computed whole")
            continue
        for name, fn in blocks.items():
            total = torch.zeros(whole[name].shape, dtype=torch.float32,
                                device="cuda")
            for tp, local in views:
                total += fn(local, tp).float()
            ref = whole[name].float()
            err = (total.to(torch.bfloat16).float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = bool(torch.isfinite(total).all()) and \
                err <= TOL["torch.bfloat16"] * scale
            tp = views[0][0]
            split = tp.heads if name == "attn" else tp.d_ff
            row = dict(arch=arch, block=name, model=m, ok=ok, err=err,
                       max_abs=scale, blocks=split.size)
            log(f"[kernels] tp {arch} {name} |model| {m}: sum of {m} "
                f"partials vs whole, max err {err:.4g} of max |out| "
                f"{scale:.4g} (bound {TOL['torch.bfloat16'] * scale:.4g}) "
                f"ok={ok}")
            rows.append(row)
            if not ok:
                failed.append(("tp", arch, name, m))
        for tp, local in views:
            # the heads a rank's flash launch and q/k-norms take: its
            # projections of one token, paired as its attention pairs them
            q, k, v = L._qkv(local["attn"], cfg, x[:1, :1], pos[:1, :1])
            kq = L.kv_for_heads(k, v, cfg, tp)[0]
            shapes.add(("flash_attention", (B, S, S, q.shape[2],
                                            kq.shape[2], cfg.head_dim,
                                            True, 0)))
            if cfg.qk_norm:
                shapes.add(("rmsnorm", (B * S * q.shape[2], cfg.head_dim)))
                shapes.add(("rmsnorm", (B * S * k.shape[2], cfg.head_dim)))
    return rows, shapes, failed


def tp_cases(rows: dict, seed: int, gen) -> list:
    """Phase 1's tensor-parallel check over TP_ARCHS, then flash attention
    (beside SDPA with ``enable_gqa``) and RMSNorm checked and timed at
    each shape a rank ran that the other cases do not cover; into
    rows["tp"]; the failures."""
    import torch
    from repro_torch.configs import get_config
    failed, shapes, out = [], set(), []
    for arch, with_mlp in TP_ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=1)
        got, sh, bad = tp_layer_check(cfg, with_mlp, seed, gen)
        out += got
        shapes |= sh
        failed += bad
        free_memory(f"tp {arch}")
    covered = {("flash_attention", tuple(c)) for c in ZOO_ATTN} | {
        ("rmsnorm", tuple(c)) for c in TRAIN_NORM + ZOO_NORM}
    rows["tp"] = {"layers": out, "flash_attention": [], "rmsnorm": []}
    for name, case in sorted(shapes - covered):
        fn = attention_case if name == "flash_attention" else rmsnorm_case
        r = fn(case, torch.bfloat16, gen)
        lib = "sdpa" if name == "flash_attention" else "lib"
        log(f"[kernels] {name} ({r['variant']}) tp {case} bf16: "
            f"ok={r['ok']} err={r['max_abs_err']:.3g} ms={r['ms']:.5f} "
            f"plain={r['plain_ms']:.4f} {lib}={r['library_ms']:.5f} "
            f"bound={r['bound_ms']:.5f} ({r['bound_by']})")
        if not r["ok"]:
            failed.append((name, case, "bf16"))
        rows["tp"][name].append(dict(case=list(case), variant=r["variant"],
                                     **{k: r[k] for k in TIMES}))
    return failed


def tensor_core_instructions(library) -> int:
    """HGMMA (wgmma) instructions in a built library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def phase_kernels(seed: int) -> dict:
    """Build, check and time the kernels; returns the slice-shape rows."""
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[kernels] nvcc build {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line or (
                    "spill" in line and " 0 bytes spill stores" not in line):
                log(f"[kernels] {name}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    failed = []
    rows = {"hgmma": {}}
    for name in TC_SOURCES:
        n = rows["hgmma"][name] = tensor_core_instructions(
            build.library_path(name))
        log(f"[kernels] {name}: {n} HGMMA instructions in its SASS")
        if not n:
            failed.append((name, "no HGMMA in SASS"))
    for dtype in (torch.float32, torch.bfloat16):
        for case in ATTN_CASES + [ATTN_SLICE]:
            r = attention_case(case, dtype, gen)
            tag = "slice" if case == ATTN_SLICE else "case"
            log(f"[kernels] flash_attention ({r['variant']}) {tag} {case} "
                f"{dtype}: ok={r['ok']} err={r['max_abs_err']:.3g} "
                f"ms={r['ms']:.5f} plain={r['plain_ms']:.4f} "
                f"sdpa={r['library_ms']:.5f} bound={r['bound_ms']:.5f} "
                f"({r['bound_by']}) {r['tflops']:.1f} TFLOP/s")
            if not r["ok"]:
                failed.append(("flash_attention", case, str(dtype)))
            if case == ATTN_SLICE:
                rows[f"flash_attention/{r['variant']}"] = r
        for shape in NORM_CASES:
            r = rmsnorm_case(shape, dtype, gen)
            log(f"[kernels] rmsnorm ({r['variant']}) {shape} {dtype}: "
                f"ok={r['ok']} "
                f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
                f"bound={r['bound_ms']:.4f} ({r['bound_by']})")
            if not r["ok"]:
                failed.append(("rmsnorm", shape, str(dtype)))
            if dtype == torch.bfloat16 and shape in (
                    NORM_SLICE, NORM_DESIGN_SHAPE):
                rows[f"rmsnorm/{shape[1]}"] = r
        for case in SSD_CASES + [SSD_SLICE]:
            r = ssd_case(case, dtype, gen)
            tag = "slice" if case == SSD_SLICE else "case"
            log(f"[kernels] ssd_scan ({r['variant']}) {tag} {case} {dtype}: "
                f"ok={r['ok']} y err {r['max_abs_err']:.3g} (|y| max "
                f"{r['y_max_abs']:.3g}) h err {r['h_max_abs_err']:.3g} "
                f"ms={r['ms']:.5f} plain={r['plain_ms']:.4f} "
                f"bound={r['bound_ms']:.5f} ({r['bound_by']}; at the f32 "
                f"peak {r['bound_f32_peak_ms']:.5f})")
            if not r["ok"]:
                failed.append(("ssd_scan", case, str(dtype)))
            if case == SSD_SLICE:
                rows[f"ssd_scan/{r['variant']}"] = r
    failed += ssd_chunk_invariance(gen)
    failed += path_shape_cases(rows, gen)
    t1 = time.perf_counter()
    failed += tp_cases(rows, seed, gen)
    log(f"[kernels] tp cases {time.perf_counter() - t1:.1f} s")
    r = ssd_case(SSD_LONG, torch.bfloat16, gen, timing_only=True)
    log(f"[kernels] ssd_scan ({r['variant']}) long {SSD_LONG} bf16, timing "
        f"only: ms={r['ms']:.5f} plain={r['plain_ms']:.4f} "
        f"bound={r['bound_ms']:.5f} ({r['bound_by']}); max diff from plain "
        f"y {r['max_abs_err']:.3g} h {r['h_max_abs_err']:.3g}; "
        f"deterministic {r['ok']}")
    if not r["ok"]:
        failed.append(("ssd_scan", SSD_LONG, "bf16"))
    rows["ssd_scan/long"] = r
    passes = rows["ssd_scan/passes"] = ssd_passes(gen)
    log(f"[kernels] ssd_scan (tc) at {SSD_SLICE} bf16, device ms per "
        f"launch: {passes}")
    turns = rows["ssd_scan/turns"] = ssd_variants_in_turns(gen)
    log(f"[kernels] ssd_scan at {SSD_SLICE} bf16, in turns (fma, tc, tc, "
        f"fma): {turns}")
    if not max(turns["tc"]) < min(turns["fma"]):
        failed.append(("ssd_scan", "tc not faster than fma", turns))
    r = attention_case(ATTN_LONG, torch.bfloat16, gen, timing_only=True)
    log(f"[kernels] flash_attention ({r['variant']}) long {ATTN_LONG} "
        f"bf16, timing only: ms={r['ms']:.5f} sdpa={r['library_ms']:.5f} "
        f"bound={r['bound_ms']:.5f} ({r['bound_by']}), "
        f"{r['tflops']:.1f} TFLOP/s; max diff from SDPA "
        f"{r['max_abs_err']:.3g}; deterministic {r['ok']}")
    if not r["ok"]:
        failed.append(("flash_attention", ATTN_LONG, "bf16"))
    rows["flash_attention/long"] = r
    designs = rmsnorm_designs(gen)
    for shape, res in designs.items():
        log(f"[kernels] rmsnorm designs at {shape} bf16, in turns: "
            + "; ".join(f"{k} {v['ms']} ms ok={v['ok']}"
                        for k, v in res.items()))
        failed += [("rmsnorm", shape, k) for k, v in res.items()
                   if not v["ok"]]
    rows["rmsnorm/designs"] = {shape: {k: v["ms"] for k, v in res.items()}
                               for shape, res in designs.items()}
    if failed:
        raise SystemExit(f"kernel check failed: {failed}")
    return rows


# ------------------------------------------------- phase 1, gradients
# tests/test_kernels.py:152-207 tolerances for f32; bf16 2e-2
GRAD_TOL = {"attention": 2e-4, "ssd": 1e-3, "rmsnorm": 1e-5}
# the reference's grad test cases (f32): tests/test_kernels.py:152-207
GRAD_REF_CASES = {"attention": (1, 64, 64, 4, 2, 32, True, 0),
                  "ssd": (1, 32, 2, 16, 16, 16),
                  "rmsnorm": (32, 64)}
# the decoder zoo's training shapes (phase 10), checked as the slice
# shapes are: flash attention at h2o-danube's (B 1 x 4608, hd 80, the
# window of 4096 binding), qwen3-moe's (hd 128, GQA 32/4), qwen2-vl's
# (28/4), phi3-medium-14b's (40/10), deepseek-coder-33b's (56/8: a
# group of 7) and qwen3-moe-235b-a22b's (64/4: a group of 16); RMSNorm
# on qwen3-moe's q-norm and k-norm rows, on phi3-medium's and
# deepseek-coder's block norm rows (d 5120 and 7168) and on 235b's
# q-norm rows (131072 x 128; its k-norm rows, 8192 x 128, are
# TRAIN_NORM[2])
GRAD_ZOO_CASES = [("attention", TRAIN_ATTN[0]), ("attention", ZOO_ATTN[1]),
                  ("attention", MM_ATTN[3]), ("attention", ZOO_ATTN[4]),
                  ("attention", ZOO_ATTN[5]), ("attention", ZOO_ATTN[3]),
                  ("rmsnorm", TRAIN_NORM[1]), ("rmsnorm", TRAIN_NORM[2]),
                  ("rmsnorm", NORM_DESIGN_SHAPE), ("rmsnorm", ZOO_NORM[8]),
                  ("rmsnorm", ZOO_NORM[7])]


def _grad_inputs(name, case, dtype, gen):
    """(inputs, kwargs, the op's kernel module) of one autograd Function
    check; `case` in the shape convention of its phase-1 cases."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    if name == "attention":
        B, Sq, Sk, H, KV, hd, causal, window = case
        ins = [torch.randn(B, s, h, hd, generator=gen, device="cuda").to(
            dtype) for s, h in ((Sq, H), (Sk, KV), (Sk, KV))]
        return ins, dict(causal=causal, window=window), fa
    if name == "ssd":
        B, S, nh, P, N, chunk = case
        return list(ssd_inputs((B, S, nh, P, N), dtype, gen)), \
            dict(chunk=chunk), ssd
    rows, d = case
    return [torch.randn(rows, d, generator=gen, device="cuda").to(dtype),
            torch.randn(d, generator=gen, device="cuda")], {}, rn


def grad_case(name, case, dtype, gen, scaled: bool) -> dict:
    """The op's autograd Function (kernel forward, oracle backward)
    against plain autograd through the oracle, on the same CUDA inputs,
    for the reference's loss, the sum of squares of the outputs: its
    upstream grad is twice each path's own forward output, so a wrong
    kernel forward shows in the grads.  rtol = atol = tol, the atol
    times each input's largest |grad| when `scaled`."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd
    ins, kw, mod = _grad_inputs(name, case, dtype, gen)
    op = {"attention": ops.attention, "ssd": ops.ssd,
          "rmsnorm": ops.rmsnorm}[name]
    oracle = {"attention": ref.attention_ref, "ssd": ssd.ssd_plain,
              "rmsnorm": ref.rmsnorm_ref}[name]

    def grads(fn):
        xs = [t.detach().requires_grad_() for t in ins]
        before = mod.launches
        outs = fn(*xs, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() ** 2).sum() for o in outs)
        return torch.autograd.grad(loss, xs), mod.launches - before

    got, launched = grads(op)
    want, _ = grads(oracle)
    tol = GRAD_TOL[name] if dtype == torch.float32 else TOL[str(dtype)]
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    ok = launched == 1 and all(
        _close(g, w, tol, atol=tol * (w.float().abs().max().item()
                                      if scaled else 1.0))
        for g, w in zip(got, want))
    return {"ok": ok, "launched": launched, "tol": tol, "max_abs_err": errs,
            "grad_max_abs": [w.float().abs().max().item() for w in want]}


def phase_grads(seed: int) -> None:
    """Each autograd Function on the card, at the reference's grad test
    cases in f32 with the reference's criterion, and at the slice shapes
    and the zoo's training shapes in bf16 and f32 with the atol scaled to
    each input's largest |grad|
    (there the grads reach ~5e7: the two paths' forwards, which differ by
    rounding, feed the backward, and a fixed atol would hold the small
    grads to a bound far below the rounding of the large ones); its
    forward must launch the kernel once."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    slices = {"attention": ATTN_SLICE, "ssd": SSD_SLICE,
              "rmsnorm": NORM_SLICE}
    runs = [(n, c, torch.float32, False) for n, c in GRAD_REF_CASES.items()]
    runs += [(n, c, dt, True)
             for n, c in list(slices.items()) + GRAD_ZOO_CASES
             for dt in (torch.bfloat16, torch.float32)]
    failed = []
    for name, case, dtype, scaled in runs:
        r = grad_case(name, case, dtype, gen, scaled)
        log(f"[grads] {name} {case} {dtype} sum(out^2): ok={r['ok']} "
            f"kernel launches {r['launched']}; max |grad err| per input "
            f"{[f'{e:.3g}' for e in r['max_abs_err']]} (|grad| max "
            f"{[f'{g:.3g}' for g in r['grad_max_abs']]}; rtol = atol = "
            f"{r['tol']}{' x |grad| max' if scaled else ''})")
        if not r["ok"]:
            failed.append((name, case, str(dtype)))
    if failed:
        raise SystemExit(f"gradient check failed: {failed}")


# ----------------------------------------------------------------- phase 2
SERVE_B, SERVE_S, SERVE_MAX = 4, 512, 1024
SERVE_TOKENS = 16
# each serving path: its config, the layers kept (None: all), its
# snapshot modes, the kernels it must launch, and the depth of its logit
# check (None: every layer).  mamba2 serves 8 of its 64 layers for the
# run's time budget (16 -> 8: -4.9 s, tools/cut_ab.py in turns, H100)
SERVE_PATHS = (
    ("qwen1.5-0.5b", None, ("sync", "async"), ("flash_attention", "rmsnorm"),
     None),
    ("mamba2-2.7b", 8, ("sync",), ("ssd_scan", "rmsnorm"), 4),
)
# At full width the bf16 kernel path and the bf16 plain path round at
# different places (the kernels keep attention scores and probabilities in
# f32), and many random layers amplify that: both are held against the f32
# plain path, and the kernel path must be no further from it than
# LOGIT_SLACK times the plain bf16 path's own distance.  Mamba2's 64
# random layers carry both bf16 paths O(1) logits away from f32, where a
# wrong SSD kernel would not show, so its check runs the first 4 layers of
# the full-width params.
LOGIT_SLACK = 1.5


# the kernels with a tensor-core and a CUDA-core variant
VARIANT_KERNELS = ("flash_attention", "ssd_scan")


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    return {"flash_attention": fa, "rmsnorm": rn, "ssd_scan": ssd}


def _zero_counters() -> None:
    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    for name in VARIANT_KERNELS:
        mod = counters[name]
        mod.launches_tc = mod.launches_fma = 0
        mod.served.clear()


def _variants() -> dict:
    """Launches of each variant of flash attention and the SSD scan since
    the counters were zeroed, with the shapes each served: [dtype, hd, n]
    for flash attention, [dtype, P, N, n] for the SSD scan."""
    out = {}
    for name in VARIANT_KERNELS:
        mod = _counters()[name]
        served = {"tc": [], "fma": []}
        for (kind, dtype, *dims), n in sorted(mod.served.items()):
            served[kind].append([dtype, *dims, n])
        out[name] = {"tc": mod.launches_tc, "fma": mod.launches_fma,
                     "served": served}
    return out


def check_small_reference(arch: str, seed: int) -> None:
    """The card's kernel path agrees with the CPU plain path on a small
    input (the smoke config, f32, the same params, the batch of
    ``serve_batch``: whisper's frames, qwen2-vl's vision embeddings and
    image positions): logits to 1e-3."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.encdec import build_model
    cfg = get_smoke_config(arch)
    cpu = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    gpu = build_model(cfg, compute_dtype=torch.float32, use_kernels=True,
                      device="cuda")
    params = cpu.init(seed)
    batch = serve_batch(cfg, 2, 24, seed)
    want, _ = cpu.prefill(params, _device_batch(batch, "cpu"))
    got, _ = gpu.prefill(_map(lambda t: t.cuda(), params),
                         _device_batch(batch, "cuda"))
    err = (got.cpu() - want).abs()[:, :cfg.vocab_size].max().item()
    log(f"[reference] {cfg.name}, card kernels vs CPU plain: max logit "
        f"err {err:.3g} (tol 1e-3)")
    if not err <= 1e-3:
        raise SystemExit(f"{arch}: card path disagrees with the CPU "
                         f"reference")


def serve_batch(cfg, B: int, S: int, seed: int) -> dict:
    """A batch of B prompts of S tokens from `seed`, as numpy: random
    tokens; an encoder-decoder's frames (B, num_audio_frames, d); a VLM's
    prompts open with one image of ``cfg.num_patches`` vision embeddings
    on a square grid (the reference pipeline's scale, 0.02), with its
    M-RoPE positions (``layers.image_positions``)."""
    import numpy as np
    from repro_torch.models.layers import image_positions
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(0, 0.1, (
            B, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.vision_stub:
        side = int(round(cfg.num_patches ** 0.5))
        batch["vision_embeds"] = rng.normal(0, 0.02, (
            B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        batch["positions"] = image_positions(B, S, (side, side)).numpy()
    return batch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _image_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir() if f.is_file())


def serve_image(srv, card: str) -> dict:
    """Snapshot the server at its position; the image's stats (the write
    joined first for an async image)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = srv.checkpoint(srv.pos)
    dump_s = time.perf_counter() - t0
    st = dict(srv.session.last_stats)
    srv.session.wait_pending()
    st.update(srv.session.last_stats)
    man = srv.session.store.manifest(srv.pos)
    out = dict(step=srv.pos, path=path, dump_s=dump_s, manifest=man,
               image=_image_bytes(path),
               freeze_ms=(st["lock_s"] + st["frozen_s"]) * 1e3,
               **{k: st[k] for k in ("write_s", "hash_s", "io_s",
                                     "written_bytes", "reused_bytes")})
    log(f"[serve] {srv.cfg.name} image at pos {out['step']} (parent "
        f"{man['parent']}): freeze {out['freeze_ms']:.1f} ms, write_s "
        f"{out['write_s']:.3f} (hash_s {out['hash_s']:.3f} of it: the "
        f"host's CRCs; io_s {out['io_s']:.3f}, appender threads), "
        f"written_bytes {out['written_bytes']:.0f}, reused_bytes "
        f"{out['reused_bytes']:.0f}, files {out['image']} bytes; {card}")
    return out


def check_delta_image(srv, images, params) -> None:
    """The second image of the sync path is a delta of the first: it
    names it as parent, writes at most the cache plus one chunk per entry
    and reuses at least the params' bytes."""
    first, second = images
    man = second["manifest"]
    cache_b = sum(t.nbytes for t in _leaves(srv.cache))
    param_b = sum(t.nbytes for t in _leaves(params))
    limit = cache_b + len(man["entry_bytes"]) * (4 << 20)
    ok = (man["parent"] == first["step"]
          and man["written_bytes"] <= limit
          and man["reused_bytes"] >= param_b)
    log(f"[serve] {srv.cfg.name} delta image: parent {man['parent']} "
        f"(want {first['step']}), written_bytes {man['written_bytes']} <= "
        f"cache {cache_b} + {len(man['entry_bytes'])} entries x 4 MiB = "
        f"{limit}, reused_bytes {man['reused_bytes']} >= params "
        f"{param_b}: {ok}")
    if not ok:
        raise SystemExit(f"{srv.cfg.name}: the incremental image is not "
                         f"a delta of the first")


def phase_serving(arch: str, layers, modes, kernels, check_layers,
                  seed: int, workdir: str, card: str) -> dict:
    """Serve `arch` at full width with snapshots; returns the kernels'
    launches on this serving path, and those of flash attention and the SSD
    scan by variant."""
    import numpy as np
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    dev = torch.device("cuda")
    model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
               device=dev)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} of {full.num_layers} "
        f"layers, d={cfg.d_model}, "
        f"vocab {cfg.padded_vocab}; {n_params} f32 params "
        f"({n_params * 4 / 2**30:.2f} GiB) in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)

    _zero_counters()                  # this path's launches start here
    for mode in modes:
        run = os.path.join(workdir, mode)
        # the sync path writes incremental images; the async path's fresh
        # server restores lazily
        opts = CheckpointOptions(mode=mode, incremental=mode == "sync")
        srv = DecodeServer(cfg, run, max_seq=SERVE_MAX, options=opts,
                           device=dev, model=model)
        srv.load(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.start({"tokens": prompts})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        srv.decode(SERVE_TOKENS)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / SERVE_TOKENS
        images = [serve_image(srv, card)]
        if mode == "sync":                       # (a)/(c): a delta image
            srv.decode(SERVE_TOKENS)
            images.append(serve_image(srv, card))
            check_delta_image(srv, images, params)
        expected = srv.decode(SERVE_TOKENS).copy()
        srv.session.wait_pending()

        restore_opts = opts.replace(restore_mode="lazy") \
            if mode == "async" else opts                # (b)
        t0 = time.perf_counter()
        fresh = DecodeServer(cfg, run, max_seq=SERVE_MAX,
                             options=restore_opts, device=dev, model=model)
        fresh.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rst = dict(fresh.session.last_stats)
        got = fresh.decode(SERVE_TOKENS)
        same = fresh.pos == srv.pos and np.array_equal(got, expected)
        first = images[0]
        if mode == "async":
            lazy = (f"lazy cold restore {restore_s:.2f} s to resume "
                    f"(restore_critical_s "
                    f"{rst['restore_critical_s']:.3f}, "
                    f"{rst['critical_bytes']:.0f} critical bytes: "
                    f"serve_state/params), restore_background_s "
                    f"{fresh.session.last_stats['restore_background_s']:.3f}"
                    f" (the cache, joined at the first decode step)")
        else:
            lazy = (f"eager cold restore of image {len(images)} "
                    f"{restore_s:.2f} s")
        log(f"[serve] {cfg.name} {mode}: prefill {prefill_ms:.1f} ms "
            f"(B={SERVE_B}, S={SERVE_S}); decode {decode_ms:.2f} ms/token; "
            f"snapshot at pos {first['step']}: freeze (lock + D2H) "
            f"{first['freeze_ms']:.1f} ms, dump call {first['dump_s']:.2f} "
            f"s, write {first['write_s']:.2f} s, image {first['image']} "
            f"bytes; {lazy}; continuation token-exact: {same}; {card}")
        if not same:
            raise SystemExit(f"{cfg.name} {mode}: cold-restored server "
                             f"diverged")
        del srv, fresh
        shutil.rmtree(run)            # one image set on the disk at a time
        torch.cuda.empty_cache()
    launches, variants = path_launches(cfg, kernels, "serve")
    check_logits(cfg, params, {"tokens": prompts}, check_layers, "serve")
    profile_serving(model, params, {"tokens": prompts}, dev)
    return launches, variants


def path_launches(cfg, kernels, tag: str) -> tuple:
    """The kernels' launches since the counters were zeroed, in all and
    by variant; fails if a kernel of the path did not run, or if bf16
    flash attention or the SSD scan ran on anything but the tensor-core
    kernel."""
    launches = {name: mod.launches for name, mod in _counters().items()}
    variants = _variants()
    log(f"[{tag}] {cfg.name}: kernel launches on the serving path: "
        f"{launches}; by variant: {variants}")
    if not all(launches[k] for k in kernels):
        raise SystemExit(f"{cfg.name}: a kernel of the path was not "
                         f"launched while serving: {launches}")
    # bf16 at the zoo's shapes runs on the tensor cores, never on FMAs
    for name in VARIANT_KERNELS:
        v = variants[name]
        if name in kernels and not (v["tc"] and not v["fma"]):
            raise SystemExit(f"{cfg.name}: bf16 {name} did not go through "
                             f"the tensor-core kernel alone: {v}")
    return launches, variants


def check_logits(cfg, params, batch, check_layers, tag: str,
                 every_position: bool = False) -> None:
    """The bf16 kernel path's prefill logits at full width against the f32
    plain path, no further from it than LOGIT_SLACK times the bf16 plain
    path (launches not counted): the largest error at the last position,
    or with `every_position` the mean error over every position of the
    forward (a MoE layer's top-k flips at near ties in either bf16 path,
    which moves a few logits by O(1) at random: the mean is the stable
    measure there)."""
    import torch
    from repro_torch.models.encdec import build_model
    dev = torch.device("cuda")
    ccfg, cparams = cfg, params
    if check_layers:
        ccfg = dataclasses.replace(cfg, num_layers=check_layers)
        n_sb = check_layers // len(cfg.layer_pattern)
        cparams = dict(params, blocks=_map(lambda t: t[:n_sb],
                                           params["blocks"]))
    batch = _device_batch(batch, dev)
    out = {}
    for name, m in (("kernels", build_model(
                        ccfg, compute_dtype=torch.bfloat16,
                        use_kernels=True, device=dev)),
                    ("plain", build_model(ccfg, compute_dtype=torch.bfloat16,
                                          device=dev)),
                    ("f32", build_model(ccfg, compute_dtype=torch.float32,
                                        device=dev))):
        with torch.no_grad():
            logits = (m.forward(cparams, batch) if every_position
                      else m.prefill(cparams, batch)[0])
        out[name] = logits[..., :cfg.vocab_size].float()
    ref = out["f32"]
    diff = {k: (out[k] - ref).abs() for k in ("kernels", "plain")}
    err = {k: d.max().item() for k, d in diff.items()}
    mean = {k: d.mean().item() for k, d in diff.items()}
    agree = {k: (out[k].argmax(-1) == ref.argmax(-1)).float().mean().item()
             for k in ("kernels", "plain")}
    log(f"[{tag}] {cfg.name} ({ccfg.num_layers} layers) "
        f"{'forward' if every_position else 'prefill'} logits "
        f"{tuple(ref.shape)} (|logit| max {ref.abs().max().item():.3g}) "
        f"against the f32 plain path: bf16 kernels max err "
        f"{err['kernels']:.3g}, mean {mean['kernels']:.3g}, argmax "
        f"agreement {agree['kernels']:.3f}; bf16 plain max err "
        f"{err['plain']:.3g}, mean {mean['plain']:.3g}, argmax agreement "
        f"{agree['plain']:.3f}; bf16 kernels vs bf16 plain max diff "
        f"{(out['kernels'] - out['plain']).abs().max().item():.3g}")
    held = mean if every_position else err
    if not (torch.isfinite(out["kernels"]).all()
            and held["kernels"] <= LOGIT_SLACK * held["plain"]):
        raise SystemExit(f"{cfg.name}: full-width kernel path is further "
                         f"from the f32 reference than the plain bf16 path")


def profile_serving(model, params, batch, dev,
                    max_seq: int = SERVE_MAX) -> None:
    """torch.profiler over one prefill and a few decode steps (outside the
    counted window): device busy share and the ops that take its time."""
    import torch
    inputs = _device_batch(batch, dev)
    B, S = inputs["tokens"].shape
    cache = model.init_cache(B, max_seq)
    last = inputs["tokens"][:, -1]
    runs = {
        "prefill": (1, lambda i: model.prefill(params, inputs)),
        "decode": (4, lambda i: model.decode_step(params, cache, last,
                                                  S + i)),
    }
    for name, (steps, fn) in runs.items():
        fn(0)                                                  # warm
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                fn(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        # device rows only (kernels, copies): a CPU op's self device time
        # is the kernels it launched, which have rows of their own
        rows = [e for e in prof.key_averages()
                if e.device_type != torch.autograd.DeviceType.CPU
                and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in rows) / steps / 1e3
        n_ops = sum(e.count for e in rows) // steps
        log(f"[profile] {model.cfg.name} {name} (profiled): wall "
            f"{wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
            f"({busy_ms / wall_ms:.0%}), {n_ops} device kernels and "
            f"copies/step")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"[profile]   {e.key[:60]}: "
                f"{e.self_device_time_total / steps / 1e3:.3f} ms/step "
                f"x{e.count // steps}")


# ---------------------------------------------------------------- phase 2b
# The decoder zoo at its published widths, bf16 compute, kernels on: (arch,
# layers kept (None: all), param dtype, batch, prompt, max_seq, tokens
# decoded, kernels of the path, depth of the logit check (None: every
# layer)).  Depth and param dtype are cut only where
# the card's memory or the run's time forces it: qwen3-moe-30b-a3b's 48
# layers are 61 GB of bf16 params (their image too slow to write for this
# run), so 2 of them (12 until phase 7 came in, 6 until phase 9, 4 until
# a whole run overran its limit: tools/cut_ab.py, the cut to 6 saved 17.2
# s, that to 4 17.5 s, that to 2 --layers 2);
# jamba-v0.1-52b's 32 layers are 105 GB, so one whole
# period of 8 (7 Mamba, 1 attention, 4 MoE, 4 dense MLP; its depth must be
# a multiple of 8).  h2o-danube at 4 of its 24 layers, cut for the run's
# time (tools/cut_ab.py: 24 -> 12 -15.7 s, 12 -> 4 -10.9 s); its
# prompt of 4608 puts the window (4096) inside the prefill and wraps the
# ring in decode.  qwen3-moe-235b-a22b at 1 of its 94 layers: one layer's
# experts are 2.42 B params, the embedding and head 1.24 B, 7.5 GB of
# bf16 in all (serving, not training, fits one card: ROADMAP A.13.5).
# phi3-medium-14b and deepseek-coder-33b (dense, untied head, no QKV
# bias) at 4 of their 40 and 62 layers in bf16: 2.39 B and 2.58 B
# params, images of ~4.8 and ~5.2 GB, cut for the run's time (their
# images' write and cold restore).  As
# for mamba2, the logit check keeps 4 layers (qwen3-moe-30b its 2,
# 235b its 1) where many random layers carry both bf16 paths O(1) logits
# away from f32, so that a wrong kernel would not show; jamba keeps its
# one period of 8.
ZOO_PATHS = (
    ("h2o-danube-1.8b", 4, "float32", 2, 4608, 4672, 48,
     ("flash_attention", "rmsnorm"), 4),
    ("qwen3-moe-30b-a3b", 2, "bfloat16", 4, 512, 576, 32,
     ("flash_attention", "rmsnorm"), 2),
    ("jamba-v0.1-52b", 8, "bfloat16", 2, 1024, 1088, 32,
     ("flash_attention", "rmsnorm", "ssd_scan"), None),
    ("qwen3-moe-235b-a22b", 1, "bfloat16", 4, 512, 576, 32,
     ("flash_attention", "rmsnorm"), 1),
    ("phi3-medium-14b", 4, "bfloat16", 4, 512, 576, 32,
     ("flash_attention", "rmsnorm"), 4),
    ("deepseek-coder-33b", 4, "bfloat16", 4, 512, 576, 32,
     ("flash_attention", "rmsnorm"), 4),
)


def host_available_gib() -> float:
    """MemAvailable of the host, GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def free_memory(tag: str) -> None:
    """Before a child process takes the card: collect the reference
    cycles (a trainer or server and its session) that still hold tensors,
    return the cached device blocks and, where torch offers it, the
    cached pinned host blocks; log what this process still holds."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    host_empty = getattr(torch._C, "_host_emptyCache", None)
    if host_empty is not None:
        host_empty()
    log(f"[memory] before {tag}: this process holds "
        f"{torch.cuda.memory_allocated()} B allocated, "
        f"{torch.cuda.memory_reserved()} B reserved on the card; host "
        f"MemAvailable {host_available_gib():.1f} GiB")


def phase_zoo(path, seed: int, workdir: str, card: str,
              tag: str = "zoo") -> tuple:
    """Serve one ZOO_PATHS or MM_PATHS path at full width: prefill (the
    prompts of ``serve_batch``), decode half its tokens, a sync image (an
    encoder-decoder: a quarter more and an incremental image, which must
    write its self cache alone), the rest; a fresh server cold-restores
    each image and must decode the same tokens.  Returns the path's
    launches, in all and by variant (counted from before the prefill to
    after the last fresh server's decode)."""
    import numpy as np
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_config
    from repro_torch.models.encdec import build_model
    from repro_torch.runtime.server import DecodeServer

    arch, layers, pdtype, B, S, max_seq, n_tok, kernels, check_layers = path
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    encdec = cfg.encoder_layers > 0
    dev = torch.device("cuda")
    model = build_model(cfg, compute_dtype=torch.bfloat16,
                        param_dtype=getattr(torch, pdtype), use_kernels=True,
                        device=dev)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.nbytes for t in _leaves(params))
    batch = serve_batch(cfg, B, S, seed)
    log(f"[{tag}] {arch}: {cfg.num_layers} of {full.num_layers} layers "
        f"(cut: {'none' if layers is None else 'depth'}; encoder "
        f"{cfg.encoder_layers}), pattern {cfg.layer_pattern}, "
        f"d={cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x "
        f"{cfg.head_dim}, window {cfg.sliding_window}, experts "
        f"{cfg.moe_num_experts} top-{cfg.moe_top_k} x {cfg.moe_d_ff}, SSM "
        f"N={cfg.ssm_state} P={cfg.ssm_headdim}, M-RoPE {cfg.mrope}; "
        f"{n_params} {pdtype} params ({nbytes / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.1f} s; B={B}, prompt {S}, max_seq "
        f"{max_seq}, {n_tok} tokens; inputs "
        f"{ {k: v.shape for k, v in batch.items()} }")

    run = os.path.join(workdir, "sync")
    opts = CheckpointOptions(mode="sync", incremental=encdec)
    _zero_counters()                  # this path's launches start here
    srv = DecodeServer(cfg, run, max_seq=max_seq, options=opts, device=dev,
                       model=model)
    srv.load(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.start(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if encdec:                 # the cross cache holds every frame
        want = {"self_k": max_seq, "cross_k": cfg.num_audio_frames}
        got = {k: srv.cache[k].shape[2] for k in want}
    else:                      # an SWA layer's a ring of the window
        want = {f"pos{j}": (min(max_seq, cfg.sliding_window)
                            if kind == "swa" else max_seq)
                for j, kind in enumerate(cfg.layer_pattern)
                if kind != "mamba"}
        got = {p: srv.cache[p]["k"].shape[2] for p in want}
    if got != want:
        raise SystemExit(f"{arch}: KV cache lengths {got}, want {want}")
    t0 = time.perf_counter()
    srv.decode(n_tok // 2)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (n_tok // 2)
    images = [serve_image(srv, card)]
    if encdec:
        srv.decode(n_tok // 4)
        images.append(serve_image(srv, card))
        check_encdec_delta(srv, images, params)
    srv.decode(S + n_tok - srv.pos)
    cache_b = sum(t.nbytes for t in _leaves(srv.cache))
    restores = []
    for image in images:
        avail = host_available_gib()
        t0 = time.perf_counter()
        fresh = DecodeServer(cfg, run, max_seq=max_seq, options=opts,
                             device=dev, model=model)
        fresh.restore(image["step"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        fresh.decode(srv.pos - fresh.pos)
        same = np.array_equal(fresh.tokens, srv.tokens)
        restores.append(f"image at pos {image['step']} {restore_s:.2f} s "
                        f"(host MemAvailable {avail:.1f} GiB before it, "
                        f"{host_available_gib():.1f} after), continuation "
                        f"token-exact: {same}")
        if not same:
            raise SystemExit(f"{arch}: the server cold-restored from the "
                             f"image at pos {image['step']} diverged")
        del fresh
    first = images[0]
    log(f"[{tag}] {arch}: prefill {prefill_ms:.1f} ms (B={B}, S={S}); "
        f"decode {decode_ms:.2f} ms/token; KV lengths {got} (the last "
        f"write at pos {srv.pos - 1}); sync image at pos {first['step']}: "
        f"freeze (lock + D2H) {first['freeze_ms']:.1f} ms, write "
        f"{first['write_s']:.2f} s (hash_s {first['hash_s']:.2f}), image "
        f"{first['image']} bytes (cache {cache_b}); eager cold restores: "
        f"{'; '.join(restores)}; {card}")
    del srv
    shutil.rmtree(run)                # the images go before the next path
    torch.cuda.empty_cache()
    launches, variants = path_launches(cfg, kernels, tag)
    check_logits(cfg, params, batch, check_layers, tag, every_position=True)
    torch.cuda.empty_cache()
    profile_serving(model, params, batch, dev, max_seq)
    return launches, variants


# ---------------------------------------------------------------- phase 2c
# The encoder-decoder and the VLM at their published widths, bf16 compute,
# kernels on, each path in a process of its own, served by `phase_zoo`
# (the fields of ZOO_PATHS).  whisper-tiny uncut over
# f32 masters: 16 requests of 1500 frames (30 s of audio), the 4-token
# start-of-transcript prompt, max_seq 448 (the decoder's published
# context); a sync image after half the tokens and an incremental one a
# quarter later.  qwen2-vl-7b in bf16 (f32 masters would be 30.5 GB, an
# image too slow to write in the run, as for qwen3-moe): 2 prompts of one
# 32 x 32 image (the config's 1024 vision embeddings) and 256 text tokens;
# its logit check at 4 layers, as for the zoo.  whisper uncut; qwen2-vl
# at 4 of its 28 layers, cut for the run's time budget when phase 7 came
# in (tools/cut_ab.py: 28 -> 14 saves 30.9 s, 14 -> 7 10.6 s) and to its
# logit check's 4 when qwen3-moe-235b-a22b came in (7 -> 4 8.0 s).
MM_PATHS = (
    ("whisper-tiny", None, "float32", 16, 4, 448, 96,
     ("flash_attention", "rmsnorm"), None),
    ("qwen2-vl-7b", 4, "bfloat16", 2, 1280, 1344, 32,
     ("flash_attention", "rmsnorm"), 4),
)


def check_encdec_delta(srv, images, params) -> None:
    """The encoder-decoder's second image is a delta of the first that
    writes the self cache alone: every param and cross_k / cross_v entry
    stays where the first image put it (decode never writes the encoder's
    K/V), and written_bytes is at most the self cache plus one chunk per
    entry."""
    first, second = images
    man = second["manifest"]
    self_b = srv.cache["self_k"].nbytes + srv.cache["self_v"].nbytes
    kept_b = (sum(t.nbytes for t in _leaves(params))
              + srv.cache["cross_k"].nbytes + srv.cache["cross_v"].nbytes)
    limit = self_b + len(man["entry_bytes"]) * (4 << 20)
    kept = [n for n in man["locations"]
            if "::params/" in n or "::cache/cross_" in n]
    moved = [n for n in kept if man["locations"][n].startswith(
        f"step_{second['step']:08d}/")]
    ok = (man["parent"] == first["step"] and kept and not moved
          and man["written_bytes"] <= limit
          and man["reused_bytes"] >= kept_b)
    log(f"[mm] {srv.cfg.name} delta image: parent {man['parent']} (want "
        f"{first['step']}), written_bytes {man['written_bytes']} <= self "
        f"cache {self_b} + {len(man['entry_bytes'])} entries x 4 MiB = "
        f"{limit}, reused_bytes {man['reused_bytes']} >= params + cross "
        f"cache {kept_b}; {len(kept)} param and cross-cache entries, "
        f"{len(moved)} of them written again: {ok}")
    if not ok:
        raise SystemExit(f"{srv.cfg.name}: the incremental image wrote "
                         f"more than the self cache")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ----------------------------------------------------------------- phase 3
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_PATH = "train"      # --path: phase 3's qwen1.5 training alone
# full width, cut to 12 of 24 layers to pay for phase 11 (e) (in turns,
# tools/cut_ab.py --path train --layers 12; NVIDIA H100 80GB HBM3, 700.00
# W: 24 -> 12 saved 41.7 s), then to 4 when a whole run overran its
# 1200 s limit (tools/cut_ab.py --path train --layers 4), then to 2 to
# pay for qwen3-moe-235b-a22b's serving path (4 -> 2 saved 13.7 s)
TRAIN_LAYERS = 2
TRAIN_B, TRAIN_S = 4, 512
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 12, 4, 7
TRAIN_LR, TRAIN_WARMUP = 1e-3, 4
# mamba2-2.7b at full width, cut to 4 of its 64 layers: its backward
# through the SSD oracle at 64 layers is not what this phase checks
MAMBA_ARCH, MAMBA_LAYERS = "mamba2-2.7b", 4
MAMBA_B, MAMBA_S, MAMBA_STEPS = 2, 512, 3
# the first step's grads, kernel path against plain bf16 path: per mamba
# leaf max |diff| / max |grad|, worst leaf, at most this.  Set from the
# card's readings (H100): the kernel path 0.140 and a witness whose SSD
# forward is ssd_tc_plain, the tc kernel's rounding in plain torch,
# 0.133 (the gap is the kernel's bf16 rounding, carried through 4 random
# layers); an SSD forward 2% off reads 0.456 and one that drops the carry
# between chunks 0.823
MAMBA_GRAD_TOL = 0.25
BF16_PEAK = 989e12


def _tree_equal(a, b) -> bool:
    import torch
    from repro_torch.core.device_plugin import flatten_with_paths
    fa_, fb = flatten_with_paths(a), flatten_with_paths(b)
    return fa_.keys() == fb.keys() and all(
        torch.equal(fa_[k], fb[k]) for k in fa_)


def _train_config(batch, seq, seed, **kw):
    import torch
    from repro_torch.runtime.trainer import TrainConfig
    return TrainConfig(batch_size=batch, seq_len=seq, lr=TRAIN_LR,
                       warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
                       seed=seed, compute_dtype=torch.bfloat16, **kw)


def _device_batch(batch: dict, dev) -> dict:
    import torch
    out = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _score(model, params, batch) -> float:
    """The model's loss on `batch`, forward only."""
    import torch
    with torch.no_grad():
        return float(model.loss(params, batch)[1]["loss"])


def visible_pairs(S: int, window: int = 0) -> int:
    """Causal (query, key) pairs of one sequence of S tokens, each query
    seeing at most `window` keys (itself included; 0: no window)."""
    if not window or S <= window:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def train_flops(cfg, n_params: int, B: int, S: int) -> float:
    """Operations of one training step: 6 per token for each param its
    matmuls use (forward and backward), plus each attention layer's two
    products, 4·B·H·hd per visible (query, key) pair forward, x3 with the
    backward.  A token uses every param of `n_params` but an untied
    embedding table (a gather, no product) and, of each MoE layer's
    experts, only the top-k it is routed to (the router is dense); an
    attention layer sees the causal pairs within its window.  Remat's
    recompute is not counted (MFU convention)."""
    d = cfg.d_model
    matmul = n_params - (0 if cfg.tie_embeddings else cfg.padded_vocab * d)
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    matmul -= moe_layers * (cfg.moe_num_experts - cfg.moe_top_k) \
        * 3 * d * cfg.moe_d_ff
    attn = 0.0
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if kind in ("attn", "swa"):
            window = cfg.sliding_window if kind == "swa" else 0
            attn += 3 * 4.0 * B * cfg.num_heads * cfg.head_dim \
                * visible_pairs(S, window)
    return 6.0 * matmul * B * S + attn


def _snapshot_line(tag, trainer, card) -> None:
    """Log the stats of the trainer's newest image."""
    from repro_torch.core.snapshot_io import snapshot_dir
    st = dict(trainer.session.last_stats)
    step = trainer.session.last_commit_step
    image = _image_bytes(snapshot_dir(trainer.session.run_dir, step))
    freeze_ms = (st["lock_s"] + st["frozen_s"]) * 1e3
    call_s = st.get("total_s", st.get("locked_total_s"))
    log(f"[train] {tag} snapshot at step {step}: freeze (lock + D2H) "
        f"{freeze_ms:.1f} ms, checkpoint() {call_s:.2f} s, write "
        f"{st['write_s']:.2f} s, image {image} bytes; {card}")


def phase_training(seed: int, workdir: str, card: str,
                   layers: int = TRAIN_LAYERS) -> dict:
    """Train qwen1.5-0.5b at full width through the kernels: (a) 12 steps
    with async images every 4; (b) a crash at step 7 and a restore from the
    step-4 (sync) image, bitwise (a)'s losses of steps 5-12 and final
    params; (c) cold restores of (a)'s async and (b)'s sync step-12 images,
    bitwise equal; (d) a falling loss; (e) the kernels' launches per
    executed step.  Returns the launches of this path, and those of flash
    attention and the SSD scan by variant."""
    import numpy as np
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer, run_with_restarts

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=layers)
    dev = torch.device("cuda")
    model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
               device=dev)                              # remat=True
    runs = {m: os.path.join(workdir, m) for m in ("async", "sync")}

    def trainer(mode, restore_mode="eager"):
        tcfg = _train_config(TRAIN_B, TRAIN_S, seed, ckpt_every=TRAIN_CKPT_EVERY,
                             ckpt=CheckpointOptions(mode=mode, keep=1,
                                                    restore_mode=restore_mode))
        return Trainer(cfg, tcfg, runs[mode], device=dev, model=model)

    lazy_restores = []

    def lazy_trainer():
        """(b)'s trainers restore lazily (critical train_state/params);
        each restore's stats are kept, and the background time once the
        first step has joined the stream."""
        t = trainer("sync", "lazy")
        restore, finish = t.restore, t._finish_lazy_restore

        def timed_restore(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = restore(*a, **kw)
            torch.cuda.synchronize()
            lazy_restores.append(dict(t.session.last_stats,
                                      resume_s=time.perf_counter() - t0))
            return out

        def timed_finish():
            pending = t._pending_opt_template is not None
            finish()
            if pending:
                lazy_restores[-1]["restore_background_s"] = \
                    t.session.last_stats["restore_background_s"]

        t.restore, t._finish_lazy_restore = timed_restore, timed_finish
        return t

    counters = _counters()
    t_a = trainer("async")
    t_a.initialize()
    n_params = sum(t.numel() for t in _leaves(t_a.params))
    # (d): the run's 12 batches scored before training, step 0's again (a
    # rescore without an update must be bitwise the same), and after it
    batches = [_device_batch(t_a.pipeline.peek(s), dev)
               for s in range(TRAIN_STEPS)]
    before = [_score(model, t_a.params, b) for b in batches]
    scores = [before[0], _score(model, t_a.params, batches[0])]
    del batches[1:]
    _zero_counters()                  # this path's launches start here
    torch.cuda.reset_peak_memory_stats()
    t_a.run(TRAIN_STEPS)                                            # (a)
    losses = list(t_a.metrics_history["loss"])
    step_ms = [t * 1e3 for t in t_a.straggler.times]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    _snapshot_line("(a) async", t_a, card)
    out = run_with_restarts(lazy_trainer, TRAIN_STEPS,              # (b)
                            {TRAIN_FAIL_AT: "crash"})
    t_b = out["trainer"]
    _snapshot_line("(b) sync", t_b, card)
    executed = TRAIN_STEPS + TRAIN_FAIL_AT + (TRAIN_STEPS - TRAIN_CKPT_EVERY)
    launches = {name: mod.launches for name, mod in counters.items()}
    variants = _variants()
    scores.append(_score(model, t_a.params, batches[0]))
    resumed = TRAIN_STEPS - TRAIN_CKPT_EVERY
    same_losses = np.array_equal(np.float64(losses[-resumed:]),
                                 np.float64(out["loss_history"][-resumed:]))
    same_params = _tree_equal(t_a.params, t_b.params) and _tree_equal(
        t_a.opt_state, t_b.opt_state)
    restored, restore_s = {}, {}
    for mode in ("async", "sync"):                                  # (c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = trainer(mode)
        r.restore()
        torch.cuda.synchronize()
        restore_s[mode] = time.perf_counter() - t0
        restored[mode] = r
    same_images = all(r.step == TRAIN_STEPS for r in restored.values()) \
        and _tree_equal(restored["async"].params, restored["sync"].params) \
        and _tree_equal(restored["async"].params, t_a.params)
    spread = max(before) - min(before)                              # (d)
    falls = scores[0] == scores[1] and scores[0] - scores[2] > spread
    per_step = {"flash_attention": 2 * cfg.num_layers,              # (e)
                "rmsnorm": 2 * 2 * cfg.num_layers + 1, "ssd_scan": 0}
    want = {k: v * executed for k, v in per_step.items()}
    # (a)'s steps after its first image overlap that image's background
    # write; (b)'s steps after the restore overlap no write
    med = float(np.median(step_ms[1:]))
    step_ms_b = [t * 1e3 for t in t_b.straggler.times]
    med_b = float(np.median(step_ms_b[1:]))
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, n_params, TRAIN_B, TRAIN_S)
    log(f"[train] {cfg.name}: {n_params} params (f32 masters, bf16 "
        f"compute, remat, kernels), batch {TRAIN_B} x {TRAIN_S}; losses "
        f"(a) {[round(x, 4) for x in losses]}; restarted run's last "
        f"{resumed} bitwise equal: {same_losses}; final params and "
        f"optimizer state bitwise equal: {same_params}; peak device "
        f"memory {peak_gb:.2f} GiB")
    for tag, m, all_ms in (
            ("(a), async images written in the background", med, step_ms),
            ("(b) after its restore, no write running", med_b, step_ms_b)):
        log(f"[train] {cfg.name}: step {m:.2f} ms (median but the first of "
            f"{tag}; host clock, each step ending in the loss's read-back; "
            f"all {[round(x, 1) for x in all_ms]}), "
            f"{tokens / m * 1e3:.0f} tokens/s, {flops / 1e12:.3f} "
            f"TFLOP/step (6 x {n_params} params x {tokens} tokens + causal "
            f"attention), MFU {flops / (m * 1e-3) / BF16_PEAK:.2%} of 989 "
            f"TFLOP/s bf16; {card}")
    log(f"[train] {cfg.name}: cold restore (fresh Trainer -> params and "
        f"optimizer state on the card) async image {restore_s['async']:.2f} "
        f"s, sync image {restore_s['sync']:.2f} s; restored params bitwise "
        f"equal: {same_images}; {card}")
    lz = lazy_restores[0]
    lazy_ok = (len(lazy_restores) == 1 and lz["restore_mode"] == "lazy"
               and "restore_background_s" in lz)
    log(f"[train] {cfg.name}: (b)'s lazy restore of the step-4 image "
        f"(critical train_state/params, {lz['critical_bytes']:.0f} bytes): "
        f"resumed in {lz['resume_s']:.2f} s (restore_critical_s "
        f"{lz['restore_critical_s']:.3f}), restore_background_s "
        f"{lz.get('restore_background_s', float('nan')):.3f} (m, v, step, "
        f"joined before step 5); eager cold restores above "
        f"{restore_s['async']:.2f} / {restore_s['sync']:.2f} s; {card}")
    log(f"[train] {cfg.name}: kernel launches over {executed} executed "
        f"steps: {launches} (want {want}); by variant: {variants}")
    log(f"[train] {cfg.name}: loss on step 0's batch before training "
        f"{scores[0]:.5f} (rescored {scores[1]:.5f}), after (a)'s "
        f"{TRAIN_STEPS} steps {scores[2]:.5f}: drop "
        f"{scores[0] - scores[2]:.5f}, must exceed the spread of the "
        f"{TRAIN_STEPS} batches' scores before training, {spread:.5f}: "
        f"{falls} "
        f"(the steps' own losses, each on a new batch, move within the "
        f"batches' spread: mean of the last 4 {np.mean(losses[-4:]):.4f}, "
        f"first {losses[0]:.4f})")
    bad = [name for name, ok in (
        ("restarted losses", same_losses), ("final params", same_params),
        ("lazy restore", lazy_ok),
        ("async == sync image", same_images), ("loss falls", falls),
        ("launches", launches == want),
        ("flash on tc only", variants["flash_attention"]["fma"] == 0))
        if not ok]
    if bad:
        raise SystemExit(f"{cfg.name} training failed: {bad}")
    profile_training(restored["sync"], card)
    del t_b, out, restored
    for run in runs.values():
        shutil.rmtree(run, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_training_concurrent(cfg, model, seed, workdir, card,      # (e)
                              losses, t_a)
    del t_a
    torch.cuda.empty_cache()
    return launches, variants


def phase_training_concurrent(cfg, model, seed: int, workdir: str,
                              card: str, losses, t_a) -> None:
    """Phase 3 (e): (a)'s run again with soft-freeze captures every 4
    steps: its losses bitwise (a)'s; a fresh trainer restores its first
    concurrent image (whose host state names the step at the validate
    pause), runs to step 12 and ends bitwise at (a)'s params, m and v."""
    import numpy as np
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.runtime.trainer import Trainer
    run = os.path.join(workdir, "concurrent")
    opts = CheckpointOptions(incremental=True, capture="concurrent")

    def trainer(ckpt_every=TRAIN_CKPT_EVERY):
        tcfg = _train_config(TRAIN_B, TRAIN_S, seed, ckpt_every=ckpt_every,
                             ckpt=opts)
        return Trainer(cfg, tcfg, run, device=torch.device("cuda"),
                       model=model)

    counters = _counters()
    before = {name: mod.launches for name, mod in counters.items()}
    t_e = trainer()
    t_e.initialize()
    t_e.run(TRAIN_STEPS)
    same_losses = np.array_equal(np.float64(t_e.metrics_history["loss"]),
                                 np.float64(losses))
    launches = {name: mod.launches - before[name]
                for name, mod in counters.items()}
    store = t_e.session.store
    captures = []
    for step in store.list_steps():
        reader = store.reader(step, verify=False)
        at = reader.host_state()["trainer"]["step"]
        reader.close()
        man = store.manifest(step)
        st = man["capture_stats"]
        captures.append((step, at, man["capture"]))
        # a step off the ckpt_every grid is a just-in-time image: the
        # straggler monitor fires while a speculation slows the steps
        log(f"[train] {cfg.name} (e) concurrent image {step}"
            f"{'' if step % TRAIN_CKPT_EVERY == 0 else ' (just-in-time)'}"
            f" (validate "
            f"pause at step {at}): pin_pause_s {st['pin_pause_s']:.4f}, "
            f"validate_pause_s {st['validate_pause_s']:.3f}, speculate_s "
            f"{st['speculate_s']:.3f}, dirty_entries {st['dirty_entries']} "
            f"of {st['speculated_entries']} speculated, recaptured_entries "
            f"{st['recaptured_entries']}, recaptured_bytes "
            f"{st['recaptured_bytes']:.0f}, superseded_bytes "
            f"{st['superseded_bytes']:.0f}; {card}")
    log(f"[train] {cfg.name} (e) kernel launches over {TRAIN_STEPS} steps "
        f"(not in the kernels line): {launches}")
    first_step, first_at, _ = captures[0]
    t_r = trainer(ckpt_every=0)
    resumed_at = t_r.restore(step=first_step)
    t_r.run_until(TRAIN_STEPS)
    same_end = (_tree_equal(t_r.params, t_a.params)
                and _tree_equal(t_r.opt_state, t_a.opt_state))
    log(f"[train] {cfg.name} (e): losses bitwise (a)'s: {same_losses}; "
        f"image {first_step} restored at step {resumed_at} (validate "
        f"pause at {first_at}), run to {TRAIN_STEPS}: params, m, v bitwise "
        f"(a)'s: {same_end}; {len(captures)} captures; {card}")
    periodic = set(range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1,
                         TRAIN_CKPT_EVERY))
    bad = [n for n, ok in (
        ("losses", same_losses), ("end state", same_end),
        ("captures", periodic <= {c[0] for c in captures}
         and all(c[2] == "concurrent" for c in captures)),
        ("host step", resumed_at == first_at)) if not ok]
    if bad:
        raise SystemExit(f"{cfg.name} concurrent training failed: {bad}")
    del t_e, t_r
    shutil.rmtree(run, ignore_errors=True)


# phase 4: 16 leaves of 128 MiB (2 GiB), half f32 and half bf16
RACE_LEAVES, RACE_LEAF_BYTES = 16, 128 << 20


def phase_session_race(seed: int, workdir: str, card: str) -> None:
    """The session API under capture="concurrent" with CUDA tensors: while
    the speculation's side-stream copies run, the compute stream mutates
    a known half of the leaves in place (add_ under no_grad, and a write
    by index into a view), replaces one leaf, adds a key and drops one.
    At finalize the dirty set must be exactly the touched keys, no
    untouched leaf re-captured, and the image must restore bitwise to the
    live tree at the validate pause."""
    import torch
    from repro_torch.api import CheckpointOptions, CheckpointSession
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    tree = {}
    for i in range(RACE_LEAVES):
        dtype = torch.float32 if i % 2 == 0 else torch.bfloat16
        n = RACE_LEAF_BYTES // torch.empty((), dtype=dtype).element_size()
        tree[f"w{i:02d}"] = torch.randn(n, generator=g, device=dev,
                                        dtype=dtype)
    names = sorted(tree)
    in_place = names[:RACE_LEAVES // 2]          # a known half
    replaced, dropped = names[-2], names[-1]
    run = os.path.join(workdir, "race")
    opts = CheckpointOptions(incremental=True, capture="concurrent")
    sess = CheckpointSession(run, opts, device=dev)
    sess.attach(lambda: {"state": tree})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = sess.checkpoint_begin(1)
    with torch.no_grad():                        # on the compute stream
        for k in in_place:
            if k[-1] in "02468":
                tree[k].add_(1.0)
            else:
                tree[k].view(64, -1)[3] = 7.0    # by index into a view
    tree[replaced] = tree[replaced] * 2          # identity drift
    tree["added"] = torch.ones(1 << 20, device=dev)
    del tree[dropped]
    raced = not handle.speculation_done
    if not handle.wait_speculated(600):
        raise SystemExit("speculation did not finish")
    torch.cuda.synchronize()
    backend = sess.engine.device_plugin
    dirty = {k.split("::", 1)[1] for k in handle._tracker.dirty_keys(
        backend.flatten_keys({"state": tree}))}
    touched = set(in_place) | {replaced, dropped}
    sess.checkpoint_finalize()
    st = dict(sess.last_stats)
    wall_s = time.perf_counter() - t0
    touched_bytes = sum(tree[k].nbytes for k in in_place + [replaced]) \
        + tree["added"].nbytes
    r = CheckpointSession(run, CheckpointOptions(), device=dev)
    r.attach(lambda: {"state": None})
    got = r.restore()["state"]
    same = got.keys() == tree.keys() and all(
        torch.equal(got[k], tree[k]) for k in tree)
    ok = (dirty == touched and st["dirty_entries"] == len(touched)
          and st["speculated_entries"] == RACE_LEAVES
          and st["recaptured_bytes"] <= touched_bytes and same)
    log(f"[session] concurrent capture of {RACE_LEAVES} CUDA leaves "
        f"({RACE_LEAVES * RACE_LEAF_BYTES} bytes, f32 and bf16), "
        f"{len(in_place)} mutated in place (add_, index into a view), one "
        f"replaced, one added, one dropped while the speculation ran "
        f"(still running when they were issued: {raced}): dirty set == "
        f"touched: {dirty == touched} ({sorted(dirty)}); dirty_entries "
        f"{st['dirty_entries']}, recaptured_entries "
        f"{st['recaptured_entries']}, recaptured_bytes "
        f"{st['recaptured_bytes']:.0f} (touched {touched_bytes}); "
        f"pin_pause_s {st['pin_pause_s']:.4f}, speculate_s "
        f"{st['speculate_s']:.3f}, validate_pause_s "
        f"{st['validate_pause_s']:.3f}, begin->commit {wall_s:.2f} s; "
        f"restored image == live tree at the validate pause: {same}; "
        f"{card}")
    if not ok:
        raise SystemExit("session concurrent-capture race check failed")
    del tree, got
    shutil.rmtree(run, ignore_errors=True)
    torch.cuda.empty_cache()


def profile_training(trainer, card: str) -> None:
    """torch.profiler over one training step (outside the counted
    window): device busy share and kernels per step."""
    import torch
    batch = trainer._batch()
    trainer._train_step(batch)                                 # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer._train_step(batch)["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[profile] {trainer.cfg.name} train step (profiled): wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.0%}), {sum(e.count for e in rows)} device "
        f"kernels and copies/step; {card}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.key[:60]}: "
            f"{e.self_device_time_total / 1e3:.3f} ms/step x{e.count}")


@contextlib.contextmanager
def _ssd_forward(fn):
    """``ops.ssd`` with `fn` in place of the SSD kernel's forward and the
    op's own backward (the oracle's, from the saved inputs); the other
    kernels of a kernel path stay.  `fn` None leaves the op as it is."""
    import torch
    from repro_torch.kernels import ops
    if fn is None:
        yield
        return

    class Stand(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, Bm, Cm, chunk):
            ctx.save_for_backward(x, dt, A, Bm, Cm)
            ctx.chunk = chunk
            ctx.set_materialize_grads(False)
            return fn(x, dt, A, Bm, Cm, chunk=chunk)
        backward = staticmethod(ops._SSD.backward)

    kernel = ops.ssd
    ops.ssd = lambda x, dt, A, Bm, Cm, *, chunk=128: Stand.apply(
        x, dt, A, Bm, Cm, chunk)
    try:
        yield
    finally:
        ops.ssd = kernel


def _ssd_off_by_2pc(x, dt, A, Bm, Cm, chunk):
    """A broken SSD forward for the check to catch: y 2% too large."""
    from repro_torch.kernels import ssd_scan as ssd
    y, h = ssd.ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    return (y.float() * 1.02).to(y.dtype), h


def _ssd_no_carry(x, dt, A, Bm, Cm, chunk):
    """A broken SSD forward for the check to catch: each chunk starts
    from a zero state (the carry between chunks dropped)."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    parts = [ssd.ssd_plain(x[:, i:i + chunk], dt[:, i:i + chunk], A,
                           Bm[:, i:i + chunk], Cm[:, i:i + chunk],
                           chunk=chunk) for i in range(0, x.shape[1], chunk)]
    return torch.cat([y for y, _ in parts], 1), parts[-1][1]


def phase_training_mamba(seed: int, workdir: str, card: str) -> dict:
    """mamba2-2.7b at full width, 4 of 64 layers: the first step's grads
    on the kernel path against the plain bf16 path over the mamba leaves,
    beside a witness and two broken forwards, then 3 steps through the
    SSD-scan kernel (a finite loss, 2 x 4 SSD launches per step)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer, loss_and_grads

    cfg = dataclasses.replace(get_config(MAMBA_ARCH), num_layers=MAMBA_LAYERS)
    dev = torch.device("cuda")
    model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
               device=dev)
    plain = LM(cfg, compute_dtype=torch.bfloat16, device=dev)
    tcfg = _train_config(MAMBA_B, MAMBA_S, seed)
    t = Trainer(cfg, tcfg, os.path.join(workdir, "mamba"), device=dev,
                model=model)
    t.initialize()
    batch = _device_batch(t.pipeline.peek(0), dev)
    grads = {}
    for name, m, fwd in (("kernels", model, None), ("plain", plain, None),
                         ("witness", model, ssd.ssd_tc_plain),
                         ("2% off", model, _ssd_off_by_2pc),
                         ("no carry", model, _ssd_no_carry)):
        with _ssd_forward(fwd):
            g = flatten_with_paths(loss_and_grads(m, t.params, batch)[1])
        grads[name] = {k: v for k, v in g.items() if "/mamba/" in k}

    def dist(name):
        """(max over the mamba leaves of max |diff| / max |grad| against
        the plain path, that leaf)."""
        return max(((grads[name][k].float() - w.float()).abs().max().item()
                    / w.float().abs().max().item(), k)
                   for k, w in grads["plain"].items())
    err = {k: dist(k) for k in grads if k != "plain"}
    del grads
    counters = _counters()
    _zero_counters()                  # this path's launches start here
    t.run(MAMBA_STEPS)
    launches = {name: mod.launches for name, mod in counters.items()}
    variants = _variants()
    losses = t.metrics_history["loss"]
    per_step = {"flash_attention": 0, "ssd_scan": 2 * MAMBA_LAYERS,
                "rmsnorm": 2 * 2 * MAMBA_LAYERS + 1}
    want = {k: v * MAMBA_STEPS for k, v in per_step.items()}
    log(f"[train] {cfg.name} ({MAMBA_LAYERS} of 64 layers, full width, "
        f"batch {MAMBA_B} x {MAMBA_S}, bf16, remat, kernels): losses "
        f"{[round(x, 4) for x in losses]}; first step's grads against the "
        f"plain bf16 path, max |diff| / max |grad| of the worst mamba "
        f"leaf: kernels {err['kernels'][0]:.4g} ({err['kernels'][1]}), "
        f"witness (SSD forward = ssd_tc_plain, the tc kernel's rounding "
        f"in plain torch) {err['witness'][0]:.4g} ({err['witness'][1]}), "
        f"broken SSD forwards: y 2% off {err['2% off'][0]:.4g} "
        f"({err['2% off'][1]}), no carry between chunks "
        f"{err['no carry'][0]:.4g} ({err['no carry'][1]}); limit "
        f"{MAMBA_GRAD_TOL}; launches "
        f"{launches} (want {want}); by variant: {variants}; {card}")
    ok = (np.isfinite(losses).all()
          and err["kernels"][0] <= MAMBA_GRAD_TOL
          and err["witness"][0] <= MAMBA_GRAD_TOL
          and err["2% off"][0] > MAMBA_GRAD_TOL
          and err["no carry"][0] > MAMBA_GRAD_TOL
          and launches == want and variants["ssd_scan"]["fma"] == 0)
    if not ok:
        raise SystemExit(f"{cfg.name} training failed")
    del t
    torch.cuda.empty_cache()
    return launches, variants


# ----------------------------------------------------------------- phase 5
REPL_ARCH = "qwen1.5-0.5b"
REPL_PATH = "repl"        # --path: phase 5 (a)-(c) alone (tools/cut_ab.py)
# full width, cut to 4 of its 24 layers for the run's time budget (-59.5 s
# in turns, tools/cut_ab.py --path repl, H100), then to 2 to pay for
# qwen3-moe-235b-a22b's serving path (4 -> 2 saved 8.6 s)
REPL_LAYERS = 2
REPL_TOKENS = 16          # decoded between the two replicated images
MIGRATE_TOKENS = 4        # decoded between two pre-copy rounds
MIGRATE_ROUNDS = 4        # TransferPolicy.precopy_rounds; no blackout budget
# training migration: qwen1.5 at full width cut to 4 of its 24 layers, a
# round every 2 steps, 10 steps in all.  Every round ships the whole 2.49
# GB image (AdamW rewrites every leaf), ~10 s per push from the host of an
# H100 80GB HBM3, so the replica fallback reuses the destination as its
# replica rather than pushing more images
MIG_LAYERS, MIG_EVERY, MIG_STEPS = 4, 2, 10


def precopy_migrate(session, advance, preempt, position, rep, tag):
    """The reference orchestrator's pre-copy loop
    (src/repro/orchestrator/orchestrator.py:476-531, the residual at
    :581-592): the job advances, snapshots while running, waits for the
    commit and ships a round; the controller observes it and decides.  On
    "freeze" or "fallback" the job advances once more (it runs until the
    signal is taken), a checkpoint-on-signal freezes it, and the residual
    round ships.  Returns (rounds, decisions, final step, frozen_s: from
    the signal to the end of the residual push)."""
    from repro_torch.api import TransferPolicy
    from repro_torch.transfer import PrecopyController
    ctrl = PrecopyController(TransferPolicy(mode="delta",
                                            precopy_rounds=MIGRATE_ROUNDS))
    rounds, decisions = [], []
    while True:
        advance()
        if decisions and decisions[-1].action != "continue":
            t0 = time.perf_counter()
            step = preempt()
            session.wait_pending()
            rounds.append(rep.push_round(session.run_dir, step, tag,
                                         residual=True))
            return rounds, decisions, step, time.perf_counter() - t0
        step = position()
        session.checkpoint_running(step)
        session.wait_pending()
        rounds.append(rep.push_round(session.run_dir, step, tag))
        ctrl.observe(rounds[-1])
        decisions.append(ctrl.decide())


def log_rounds(tag, rounds, decisions, card) -> None:
    for rec, d in zip(rounds, decisions + [None]):
        what = (f"decision {d.action} ({d.reason}; predicted residual "
                f"{d.predicted_residual_bytes} B)" if d is not None
                else "residual round: the blackout push")
        log(f"[migrate] {tag} round {rec['round']} (step {rec['step']}): "
            f"bytes_sent {rec['bytes_sent']}, bytes_reused "
            f"{rec['bytes_reused']}, chunks_sent {rec['chunks_sent']}, "
            f"chunks_reused {rec['chunks_reused']}, wall_s "
            f"{rec['wall_s']:.3f}; {what}; {card}")


def replicate_image(srv, card: str) -> dict:
    """A sync image of the server, pushed to its replica inside the dump:
    the dump's and the push's stats."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.checkpoint(srv.pos)
    dump_s = time.perf_counter() - t0
    st = dict(srv.session.last_stats, step=srv.pos, dump_s=dump_s)
    log(f"[replicate] {srv.cfg.name} image at pos {srv.pos}: dump "
        f"{dump_s:.2f} s = frozen_s {st['frozen_s']:.3f} + write_s "
        f"{st['write_s']:.3f} + replicate_s {st['replicate_s']:.3f} (the "
        f"delta push, inside the dump); replica_bytes_sent "
        f"{st['replica_bytes_sent']}, replica_bytes_reused "
        f"{st['replica_bytes_reused']}, replica_chunks_sent "
        f"{st['replica_chunks_sent']}, replica_chunks_reused "
        f"{st['replica_chunks_reused']}, replica_steps_transferred "
        f"{st['replica_steps_transferred']}, replica_steps_skipped "
        f"{st['replica_steps_skipped']}; written_bytes "
        f"{st['written_bytes']:.0f}, reused_bytes {st['reused_bytes']:.0f}"
        f"; {card}")
    return st


def _tear_cache_chunk(run: str, step: int) -> str:
    """Flip 4 bytes inside the first stored chunk of a KV-cache entry of
    `run`'s image `step` (a background entry of a lazy restore whose
    critical set is the params).  Returns the entry's name."""
    from repro_torch.core.snapshot_io import SnapshotStore
    from repro_torch.serialization.pack import open_pack, stripe_path
    locs = SnapshotStore(run).manifest(step)["locations"]
    entry = sorted(n for n in locs if "::cache/" in n)[0]
    base = os.path.join(run, "snapshots", locs[entry])
    with open_pack(base, verify=False) as r:
        c = r.index[entry]["chunks"][0]
    with open(stripe_path(base, c["stripe"]), "r+b") as f:
        f.seek(c["offset"] + 8)
        f.write(b"\xde\xad\xbe\xef")
    return entry


def phase_replication(seed: int, workdir: str, card: str,
                      layers: int = REPL_LAYERS) -> tuple:
    """Phase 5 (a)-(c), qwen1.5-0.5b at full width (`layers` of its 24
    layers) through the kernels:
    (a) sync incremental images delta-replicated to a peer, the second
    shipping its own chunks only; the primary's images deleted, a fresh
    server restores from the replica, token-exact; (b) a torn KV-cache
    chunk of the primary image: a lazy restore without a replicator fails
    at the barrier, one with it heals from the replica, token-exact; (c) a
    live pre-copy migration of an async incremental server to a new
    directory, token-exact there, against one full push of the final
    image to an empty peer.  Returns the kernels' launches on this path."""
    import numpy as np
    import torch
    from repro_torch.api import CheckpointOptions, TransferPolicy
    from repro_torch.configs import get_config
    from repro_torch.core.lazy import LazyRestoreError
    from repro_torch.models.lm import LM
    from repro_torch.obs import trace as obs_trace
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.transfer import DeltaReplicator, summarize_rounds

    cfg = dataclasses.replace(get_config(REPL_ARCH), num_layers=layers)
    dev = torch.device("cuda")
    model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
               device=dev)
    params = model.init(seed)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)
    delta = TransferPolicy(mode="delta")
    run, peer = os.path.join(workdir, "primary"), os.path.join(workdir,
                                                               "peer")

    def server(path, **opts):
        srv = DecodeServer(cfg, path, max_seq=SERVE_MAX, device=dev,
                           model=model, options=CheckpointOptions(**opts))
        return srv

    def timed_restore(srv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = srv.restore()
        torch.cuda.synchronize()
        return step, time.perf_counter() - t0, dict(srv.session.last_stats)

    counters = _counters()
    _zero_counters()                  # this path's launches start here
    # (a) delta replication of a serving chain, then the primary is lost
    srv = server(run, incremental=True, replicate_to=peer,
                 transfer_policy=delta)
    srv.load(params)
    srv.start({"tokens": prompts})
    images = []
    for _ in range(2):
        srv.decode(REPL_TOKENS)
        images.append(replicate_image(srv, card))
    step = srv.pos
    expected = srv.decode(REPL_TOKENS).copy()
    cache_b = sum(t.nbytes for t in _leaves(srv.cache))
    second = images[1]
    ships_cache = (second["replica_steps_skipped"] == 1
                   and cache_b <= second["replica_bytes_sent"]
                   <= cache_b + (4 << 20))
    del srv
    shutil.rmtree(os.path.join(run, "snapshots"))        # primary lost
    fresh = server(run, replicate_to=peer, transfer_policy=delta)
    got_step, restore_s, rst = timed_restore(fresh)
    from_replica = rst.get("restored_from_replica") is True \
        and got_step == step
    same_a = np.array_equal(fresh.decode(REPL_TOKENS), expected)
    log(f"[replicate] {cfg.name} (a): image 2 shipped "
        f"{second['replica_bytes_sent']} B against the KV cache's "
        f"{cache_b} B (+ host blobs, at most one 4 MiB chunk), image 1 "
        f"skipped whole: {ships_cache}; primary images deleted, fresh "
        f"server restored pos {got_step} from the replica in "
        f"{restore_s:.2f} s (pull of the image and its parent + eager "
        f"restore; restored_from_replica {rst.get('restored_from_replica')}"
        f"); continuation token-exact: {same_a}; {card}")
    del fresh
    # (b) a torn background chunk, healed from the replica
    entry = _tear_cache_chunk(run, step)
    bare = server(run, restore_mode="lazy")
    bare.restore()
    try:
        bare.decode(1)
        raised = False
    except LazyRestoreError:
        raised = True
    del bare
    healer = server(run, restore_mode="lazy", replicate_to=peer,
                    transfer_policy=delta)
    got_step, resume_s, rst = timed_restore(healer)
    same_b = got_step == step and np.array_equal(
        healer.decode(REPL_TOKENS), expected)
    healed = healer.session.last_stats.get("healed_entries", 0)
    log(f"[replicate] {cfg.name} (b): tore {entry} of the primary image; "
        f"lazy restore without a replicator raised LazyRestoreError at the "
        f"barrier: {raised}; with the replicator resumed in "
        f"{resume_s:.2f} s (restore_critical_s "
        f"{rst['restore_critical_s']:.3f}), the stream healed "
        f"{healed:.0f} entries from the replica (restore_background_s "
        f"{healer.session.last_stats['restore_background_s']:.3f}, the "
        f"re-pull included); continuation token-exact: {same_b}; {card}")
    del healer
    shutil.rmtree(run)
    shutil.rmtree(peer)
    torch.cuda.empty_cache()

    # (c) live pre-copy migration to `dest`
    src, dest = os.path.join(workdir, "src"), os.path.join(workdir, "dest")
    srv = server(src, mode="async", incremental=True)
    srv.load(params)
    srv.start({"tokens": prompts})

    def preempt():
        out = srv.decode_until(srv.pos + 1, preempt=lambda: True)
        if not out["preempted"]:
            raise SystemExit("the checkpoint-on-signal did not happen")
        return srv.pos

    rep = DeltaReplicator(dest)
    rounds, decisions, step, frozen_s = precopy_migrate(
        srv.session, lambda: srv.decode(MIGRATE_TOKENS), preempt,
        lambda: srv.pos, rep, "serve")
    log_rounds(f"{cfg.name} (c)", rounds, decisions, card)
    summary = summarize_rounds(rep.round_state("serve"))
    rep.clear_rounds("serve")
    expected = srv.decode(REPL_TOKENS).copy()
    del srv
    fresh = server(dest)
    got_step, restore_s, _ = timed_restore(fresh)
    same_c = got_step == step and np.array_equal(
        fresh.decode(REPL_TOKENS), expected)
    del fresh
    shutil.rmtree(dest)
    # the stop-and-copy push, traced: its negotiate / ship / materialize
    # phases (the replicator's own spans)
    tracer = obs_trace.Tracer()
    obs_trace.install(tracer)
    try:
        full = DeltaReplicator(os.path.join(workdir, "empty_peer")).push(
            src, step)
    finally:
        obs_trace.uninstall()
    spans = {}
    for sp in tracer.spans:
        spans[sp.name] = spans.get(sp.name, 0.0) + sp.t_end - sp.t_start
    log(f"[migrate] {cfg.name} (c): summarize_rounds {json.dumps(summary)}; "
        f"blackout (residual push) {summary['blackout_s']:.3f} s, "
        f"{summary['residual_bytes']} B; signal -> residual pushed "
        f"{frozen_s:.3f} s (the final image's freeze and write "
        f"included); stop-and-copy baseline, one full push of the final "
        f"image to an empty peer: push_s {full['push_s']:.3f}, bytes_sent "
        f"{full['bytes_sent']} ("
        f"{full['bytes_sent'] / max(1, summary['residual_bytes']):.2f}x "
        f"the residual; by phase, s: "
        f"{json.dumps({k: round(v, 3) for k, v in sorted(spans.items())})}"
        f"); restored at the destination, pos {got_step}, continuation "
        f"token-exact: {same_c}; {card}")
    shutil.rmtree(os.path.join(workdir, "empty_peer"))
    shutil.rmtree(src)
    launches = {name: mod.launches for name, mod in counters.items()}
    variants = _variants()
    log(f"[replicate] {cfg.name}: kernel launches on the replication and "
        f"migration path: {launches}; by variant: {variants}")
    bad = [name for name, ok in (
        ("(a) image 2 ships the cache", ships_cache),
        ("(a) restored from the replica", from_replica),
        ("(a) token-exact", same_a), ("(b) torn chunk raises", raised),
        ("(b) healed", healed >= 1), ("(b) token-exact", same_b),
        ("(c) residual round", summary["residual_bytes"] > 0),
        ("(c) token-exact", same_c),
        ("launches", launches["flash_attention"] > 0
         and launches["rmsnorm"] > 0),
        ("flash on tc only", variants["flash_attention"]["fma"] == 0))
        if not ok]
    if bad:
        raise SystemExit(f"{cfg.name} replication / migration failed: {bad}")
    del model, params
    torch.cuda.empty_cache()
    return launches, variants


def phase_migrate_training(seed: int, workdir: str, card: str) -> tuple:
    """Phase 5 (d): qwen1.5-0.5b at full width cut to 4 layers (batch 4 x
    512, AdamW, kernels).  A run that never migrates takes 10 steps; a
    second run migrates by pre-copy (an async image and a round every 2
    steps) and a fresh trainer at the destination resumes and runs to
    step 10: its losses, params, m and v must be the first run's,
    bitwise.  Before it runs on, the source's images are deleted and a
    fresh trainer there, with the destination as its replica, must
    restore the same state from the replica, bitwise.  Returns the
    kernels' launches on this path."""
    import torch
    from repro_torch.api import CheckpointOptions, TransferPolicy
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.transfer import DeltaReplicator, summarize_rounds

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=MIG_LAYERS)
    dev = torch.device("cuda")
    model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
               device=dev)
    src, dest = os.path.join(workdir, "t_src"), os.path.join(workdir,
                                                             "t_dest")

    def trainer(path, **opts):
        tcfg = _train_config(TRAIN_B, TRAIN_S, seed, ckpt_every=0,
                             ckpt=CheckpointOptions(**opts))
        return Trainer(cfg, tcfg, path, device=dev, model=model)

    def timed_restore(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = t.restore()
        torch.cuda.synchronize()
        return step, time.perf_counter() - t0

    def same(a, b):
        return (a.metrics_history["loss"] == b.metrics_history["loss"]
                and _tree_equal(a.params, b.params)
                and _tree_equal(a.opt_state, b.opt_state))

    counters = _counters()
    _zero_counters()                  # this path's launches start here
    ref = trainer(os.path.join(workdir, "t_ref"))   # writes no image
    ref.run(MIG_STEPS)
    t = trainer(src, mode="async", incremental=True)
    t.initialize()

    def preempt():
        out = t.run_until(t.step + 1, preempt=lambda: True)
        if not out["preempted"]:
            raise SystemExit("the checkpoint-on-signal did not happen")
        return t.step

    rep = DeltaReplicator(dest)
    rounds, decisions, step, frozen_s = precopy_migrate(
        t.session, lambda: t.run_until(t.step + MIG_EVERY), preempt,
        lambda: t.step, rep, "train")
    log_rounds(f"{cfg.name} ({MIG_LAYERS} layers) (d)", rounds, decisions,
               card)
    summary = summarize_rounds(rep.round_state("train"))
    rep.clear_rounds("train")
    del t
    fresh = trainer(dest)
    got_step, restore_s = timed_restore(fresh)
    # the source host's images are lost: its replica is the destination
    shutil.rmtree(os.path.join(src, "snapshots"))
    back = trainer(src, replicate_to=dest,
                   transfer_policy=TransferPolicy(mode="delta"))
    back_step, back_s = timed_restore(back)
    from_replica = back.session.last_stats.get("restored_from_replica") \
        is True and back_step == step
    same_r = same(back, fresh)
    del back
    fresh.run_until(MIG_STEPS)
    same_d = got_step == step and same(fresh, ref)
    log(f"[migrate] {cfg.name} ({MIG_LAYERS} layers) (d): "
        f"summarize_rounds {json.dumps(summary)}; blackout (residual push) "
        f"{summary['blackout_s']:.3f} s against round 0's "
        f"{rounds[0]['wall_s']:.3f} s; signal -> residual pushed "
        f"{frozen_s:.3f} s; destination restored step {got_step} in "
        f"{restore_s:.2f} s and ran to {MIG_STEPS}: losses, params, m, v "
        f"bitwise the unmigrated run's: {same_d}; {card}")
    log(f"[replicate] {cfg.name} ({MIG_LAYERS} layers) training: the "
        f"source's images deleted, a fresh trainer there restored step "
        f"{back_step} from its replica (the destination) in {back_s:.2f} s "
        f"(restored_from_replica {from_replica}); losses, params, m, v "
        f"bitwise the destination's: {same_r}; {card}")
    launches = {name: mod.launches for name, mod in counters.items()}
    variants = _variants()
    log(f"[replicate] {cfg.name} ({MIG_LAYERS} layers) training: kernel "
        f"launches: {launches}; by variant: {variants}")
    bad = [name for name, ok in (
        ("(d) bitwise at the destination", same_d),
        ("(d) residual round", bool(rounds[-1]["residual"])),
        ("restored from the replica", from_replica),
        ("replica bitwise", same_r),
        ("launches", launches["flash_attention"] > 0
         and launches["rmsnorm"] > 0),
        ("flash on tc only", variants["flash_attention"]["fma"] == 0))
        if not ok]
    if bad:
        raise SystemExit(f"{cfg.name} training migration failed: {bad}")
    del fresh, ref, model
    for path in (src, dest, os.path.join(workdir, "t_ref")):
        shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, variants


# ----------------------------------------------------------------- phase 6
ORCH_ARCH = "qwen1.5-0.5b"
ORCH_PATH = "orch"            # --path: phase 6 alone (tools/cut_ab.py)
# full width, parts (a)-(c) and (e) cut to 4 of the 24 layers for the
# run's time budget (-95.4 s in turns, tools/cut_ab.py --path orch,
# H100), then to 2 to pay for qwen3-moe-235b-a22b's serving path (4 -> 2
# saved 6.7 s); (d) keeps all 24: its check reads replay's restore
# growing by 12 re-executed steps against the engine's, and at 4 layers
# (a 61 ms step) that growth fell inside the restores' noise
ORCH_LAYERS = 2
REPLAY_LAYERS = 24
ORCH_TRAIN_STEPS = 6          # preemption: lo 6 steps, hi 3
ORCH_SERVE_STEPS = 6          # failure: a crash at step 4 (total//2 + 1)
ORCH_MIGRATE_STEPS = 12       # pre-copy migration from step 6
# heartbeat deadlines that fit the full-width slices (2 steps of ~0.4 s,
# 2 tokens of ~0.06 s); the reference's 0.05 s assumes smoke steps
ORCH_TRAIN_DEADLINE_S = 1.0
ORCH_SERVE_DEADLINE_S = 0.25
REPLAY_LENGTHS = (4, 16)      # interception logs replayed against images
FLEET_REPLICAS, FLEET_HOSTS = 4, 2
FLEET_TRACE = [1, 12, 0, 0, 0]
ORCH_KERNELS = ("flash_attention", "rmsnorm")


def _orch_workload(layers: int = ORCH_LAYERS):
    """qwen1.5-0.5b at full width (`layers` of its 24 layers), bf16
    compute over f32 masters, the kernels, remat; phase 3's training
    shape and phase 2's serving shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.orchestrator.workloads import WorkloadConfig
    return WorkloadConfig(model=dataclasses.replace(get_config(ORCH_ARCH),
                                                    num_layers=layers),
                          compute_dtype=torch.bfloat16, use_kernels=True,
                          remat=True, train_batch=TRAIN_B, train_seq=TRAIN_S,
                          lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          serve_batch=SERVE_B, prompt_len=SERVE_S,
                          max_seq=SERVE_MAX)


def _state_bytes(tree) -> int:
    from repro_torch.core.device_plugin import flatten_with_paths
    return sum(t.nbytes for t in flatten_with_paths(tree).values())


def _undisturbed_digest(kind, total, run, w, dev, options=None) -> str:
    """Digest of the same job (seed 0) run to `total` in slices of 2 with
    nothing injected; its device state is released after."""
    from repro_torch.orchestrator import JobSpec
    from repro_torch.orchestrator.workloads import WORKLOADS
    wl = WORKLOADS[kind](JobSpec("ref", kind=kind, total_steps=total), run,
                         device=dev, options=options, workload=w)
    wl.start()
    while not wl.done:
        wl.run_slice(2)
    wl.finish()
    digest = wl.digest()
    wl.release()
    shutil.rmtree(run, ignore_errors=True)
    return digest


def _orchestrate(name, run, kind, total, config, options, w, dev,
                 cls=None):
    from repro_torch.orchestrator import (Orchestrator, make_workload_factory,
                                          scenario_specs)
    orch = (cls or Orchestrator)(
        run, scenario_specs(name, total_steps=total, kind=kind),
        workload_factory=make_workload_factory(run, options=options,
                                               device=dev, workload=w),
        config=config)
    return orch, orch.run()


def _incident_line(inc) -> str:
    return ", ".join(f"{k} {inc[k]:.3f}" for k in (
        "detect_s", "transfer_s", "schedule_s", "restore_s", "replay_s",
        "total_s") if inc.get(k) is not None)


def orch_preemption(dev, w, workdir, card) -> tuple:
    """(a) lo (6 steps) is mid-run when hi (3 steps, priority 5) arrives
    at tick 2 on one device slot: lo checkpoints on the signal and is
    evicted, hi runs to done, lo restores and finishes.  Device memory at
    lo's eviction falls by its params + AdamW state (its grads are
    transient, freed at every step's end), and from lo's peak by params +
    AdamW state + grads.  Each job's digest equals an uninterrupted run
    of it, bitwise."""
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.core.snapshot_io import snapshot_dir
    from repro_torch.orchestrator import Orchestrator, OrchestratorConfig

    drops = []

    class Measured(Orchestrator):
        def _drop(self, job_id):
            wl = self.workloads.get(job_id)
            if wl is None or wl.trainer.params is None:
                return super()._drop(job_id)
            params = _state_bytes(wl.trainer.params)
            opt = _state_bytes(wl.trainer.opt_state)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            peak = torch.cuda.max_memory_allocated()
            super()._drop(job_id)
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            drops.append(dict(job=job_id,
                              state=self.records[job_id].state.value,
                              params=params, opt=opt, grads=params,
                              before=before, after=after, peak=peak))
            torch.cuda.reset_peak_memory_stats()

    run = os.path.join(workdir, "preempt")
    config = OrchestratorConfig(capacity=1, slice_steps=2,
                                heartbeat_deadline_s=ORCH_TRAIN_DEADLINE_S)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    t0 = time.perf_counter()
    orch, summary = _orchestrate(
        "preemption", run, "train", ORCH_TRAIN_STEPS, config,
        CheckpointOptions(mode="sync"), w, dev, cls=Measured)
    wall = time.perf_counter() - t0
    launches = path_launches(w.model_config(), ORCH_KERNELS, "orch")
    lo, hi = summary["jobs"]["lo"], summary["jobs"]["hi"]
    (inc,) = [i for i in lo["recovery"] if i["cause"] == "preemption"]
    image = _image_bytes(snapshot_dir(os.path.join(run, "job_lo"),
                                      orch.records["lo"].last_ckpt_step))
    for d in drops:
        log(f"[orch] (a) drop of {d['job']} ({d['state']}): device memory "
            f"{d['before']} -> {d['after']} B (fell "
            f"{d['before'] - d['after']} B; params {d['params']} + AdamW "
            f"{d['opt']} = {d['params'] + d['opt']} B); from the job's peak "
            f"{d['peak']} B it fell {d['peak'] - d['after']} B (params + "
            f"AdamW + grads {d['params'] + d['opt'] + d['grads']} B); "
            f"baseline before the run {base} B; {card}")
    evicted = [d for d in drops if d["state"] == "preempted"]
    ref_lo = _undisturbed_digest("train", ORCH_TRAIN_STEPS,
                                 os.path.join(workdir, "ref_lo"), w, dev)
    ref_hi = _undisturbed_digest("train", max(ORCH_TRAIN_STEPS // 2, 2),
                                 os.path.join(workdir, "ref_hi"), w, dev)
    same = (lo["digest"] == ref_lo, hi["digest"] == ref_hi)
    log(f"[orch] (a) preemption, train, capacity 1: all done "
        f"{summary['all_done']}; lo step {lo['step']}, restarts "
        f"{lo['restarts']}; recovery (s): {_incident_line(inc)} (restore "
        f"{inc['meta'].get('restore_wall_s', 0.0):.3f} s of it the image "
        f"read, steps replayed {inc['steps_replayed']}); cluster_goodput "
        f"{summary['cluster_goodput']:.4f}, lo goodput {lo['goodput']:.4f};"
        f" lo's image {image} B; scenario wall {wall:.1f} s; digests equal "
        f"to uninterrupted runs (lo, hi): {same}; {card}")
    if not (summary["all_done"] and lo["restarts"] >= 1 and all(same)):
        raise SystemExit("orchestration (a): the preempted job did not "
                         "recover bitwise")
    if len(evicted) != 1:
        raise SystemExit(f"orchestration (a): expected one eviction, got "
                         f"{drops}")
    d = evicted[0]
    if not (d["before"] - d["after"] >= d["params"] + d["opt"]
            and d["peak"] - d["after"]
            >= d["params"] + d["opt"] + d["grads"]):
        raise SystemExit(f"orchestration (a): the eviction did not free the "
                         f"job's device memory: {d}")
    shutil.rmtree(run)
    return launches


def orch_failure(dev, w, workdir, card) -> tuple:
    """(b) A serving job with an image every 2 tokens crashes at token 4:
    the heartbeat deadline detects it, it restores from its newest image
    and continues token-exact against an uninterrupted server."""
    from repro_torch.api import CheckpointOptions
    from repro_torch.orchestrator import OrchestratorConfig

    run = os.path.join(workdir, "failure")
    config = OrchestratorConfig(capacity=1, slice_steps=2,
                                heartbeat_deadline_s=ORCH_SERVE_DEADLINE_S)
    _zero_counters()
    t0 = time.perf_counter()
    orch, summary = _orchestrate("failure", run, "serve", ORCH_SERVE_STEPS,
                                 config, CheckpointOptions(mode="sync"), w,
                                 dev)
    wall = time.perf_counter() - t0
    launches = path_launches(w.model_config(), ORCH_KERNELS, "orch")
    j = summary["jobs"]["crashy"]
    (inc,) = j["recovery"]
    rec_inc = orch.records["crashy"].recovery.incidents[0]
    ref = _undisturbed_digest("serve", ORCH_SERVE_STEPS,
                              os.path.join(workdir, "ref_serve"), w, dev)
    same = j["digest"] == ref
    log(f"[orch] (b) failure, serve: crash at token "
        f"{orch.records['crashy'].spec.fail_at_step}, detected by heartbeat"
        f" (deadline {ORCH_SERVE_DEADLINE_S} s); recovery (s): "
        f"{_incident_line(inc)}; restored step {rec_inc['restored_step']} "
        f"(newest image {j['last_ckpt_step']}), steps replayed "
        f"{inc['steps_replayed']}; checkpoints {j['checkpoints']}; scenario"
        f" wall {wall:.1f} s; token-exact vs an uninterrupted server: "
        f"{same}; {card}")
    if not (summary["all_done"] and j["restarts"] == 1 and same
            and inc["cause"] == "failure" and inc["detect_s"] > 0):
        raise SystemExit("orchestration (b): the crashed server did not "
                         "recover token-exact")
    shutil.rmtree(run)
    return launches


def orch_migration(dev, w, workdir, card) -> tuple:
    """(c) A serving job on 2 hosts migrates live by pre-copy from token 6
    (incremental sync images every 2 tokens; a round per tick, the
    controller of TransferPolicy(mode="delta", precopy_rounds=4)
    deciding); at the destination it is step-exact and token-exact."""
    from repro_torch.api import CheckpointOptions, TransferPolicy
    from repro_torch.orchestrator import OrchestratorConfig

    run = os.path.join(workdir, "migrate")
    config = OrchestratorConfig(
        capacity=1, slice_steps=2, hosts=2,
        heartbeat_deadline_s=ORCH_SERVE_DEADLINE_S,
        transfer_policy=TransferPolicy(mode="delta", precopy_rounds=4))
    _zero_counters()
    t0 = time.perf_counter()
    orch, summary = _orchestrate(
        "migrate", run, "serve", ORCH_MIGRATE_STEPS, config,
        CheckpointOptions(mode="sync", incremental=True), w, dev)
    wall = time.perf_counter() - t0
    launches = path_launches(w.model_config(), ORCH_KERNELS, "orch")
    j = summary["jobs"]["mover"]
    mig = j["migration"]
    decisions = [e for e in orch.records["mover"].events
                 if "precopy_round" in e]
    for r, e in zip(mig["rounds"], decisions + [None] * len(mig["rounds"])):
        what = ("residual round: the blackout push" if r.get("residual")
                else f"decision {e['decision'] if e else '?'}")
        log(f"[orch] (c) round {r['round']}: bytes_sent {r['bytes_sent']}, "
            f"wall_s {r['wall_s']:.3f}; {what}; {card}")
    (inc,) = [i for i in j["recovery"] if i["cause"] == "migration"]
    ref = _undisturbed_digest("serve", ORCH_MIGRATE_STEPS,
                              os.path.join(workdir, "ref_mig"), w, dev)
    same = j["digest"] == ref
    log(f"[orch] (c) migration, serve, 2 hosts, pre-copy: {mig['from']} -> "
        f"{mig['to']}, {mig['state']}, outcome {mig['outcome']} "
        f"({mig.get('decision_reason')}); blackout "
        f"{mig.get('blackout_s', 0.0):.3f} s, residual "
        f"{mig.get('residual_bytes')} B, pre-copy "
        f"{mig.get('precopy_bytes')} B; recovery (s): "
        f"{_incident_line(inc)}; step {j['step']}; scenario wall "
        f"{wall:.1f} s; token-exact at the destination: {same}; {card}")
    if not (summary["all_done"] and mig["state"] == "transferred"
            and j["host"] == mig["to"] and j["step"] == ORCH_MIGRATE_STEPS
            and same):
        raise SystemExit("orchestration (c): the migrated server is not "
                         "token-exact at the destination")
    shutil.rmtree(run)
    return launches


def orch_replay(dev, w, workdir, card, seed: int) -> tuple:
    """(d) One full-width training run checkpointed two ways at each of
    REPLAY_LENGTHS: by the engine (async images) and by the interception
    baseline wrapping the step (in place: AdamW updates its inputs).  A
    replay must reproduce the engine's restored state at that step, and
    the live one at the last, bitwise.  Replay's whole restore grows with
    the log, the engine's does not (each the faster of two in turns).
    Then the `intercept` scenario (the MLP) runs to done."""
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.baselines.interception import InterceptionCheckpointer
    from repro_torch.orchestrator import JobSpec, run_scenario
    from repro_torch.orchestrator.workloads import InterceptionWorkload
    from repro_torch.runtime.trainer import (TrainConfig, Trainer,
                                             loss_and_grads)

    torch.cuda.reset_peak_memory_stats()
    cfg = w.model_config()
    model = w.build_model(dev)
    tcfg = TrainConfig(batch_size=w.train_batch, seq_len=w.train_seq,
                       lr=w.lr, warmup_steps=w.warmup_steps,
                       total_steps=REPLAY_LENGTHS[-1], seed=seed,
                       compute_dtype=w.compute_dtype,
                       ckpt=CheckpointOptions(mode="async"))
    eng_run = os.path.join(workdir, "engine")
    ic_run = os.path.join(workdir, "intercept")
    live = Trainer(cfg, tcfg, eng_run, device=dev, model=model)
    live.initialize()
    opt = live.opt

    def step_fn(params, opt_state, batch):
        """One training step on host `batch`, params and moments updated
        in place (the trainer's step as a function of its state)."""
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        b["tokens"] = b["tokens"].long()
        _, grads = loss_and_grads(model, params, b)
        opt.update(grads, opt_state, params)
        return params, opt_state

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ic = InterceptionCheckpointer(ic_run)
    _, register_s = timed(lambda: ic.register_initial_state(
        "train", {"params": live.params, "opt": live.opt_state}))
    wrapped = ic.wrap(step_fn, "step")
    wrapped_s, paths, ckpt_s = [], {}, {}
    _zero_counters()
    for s in range(1, REPLAY_LENGTHS[-1] + 1):
        batch = live.pipeline.next()
        _, dt = timed(lambda: wrapped(live.params, live.opt_state, batch))
        wrapped_s.append(dt)
        live.step = s
        if s in REPLAY_LENGTHS:
            live.session.checkpoint(s)               # async engine image
            paths[s], ckpt_s[s] = timed(lambda: ic.checkpoint(s))
    live.session.wait_pending()
    launches = path_launches(cfg, ORCH_KERNELS, "orch")

    # the engine and the replay each restore every image twice, in turns
    # (4, 16, 4, 16), and each step's faster restore is compared: in a
    # whole run of this script the part's first restore is slow (8.2-10.3
    # s against 4.8-5.7 s for the others, and so even with its image read
    # through just before it), a one-time cost of the process that the
    # phase run alone does not show; the replay's read of its 5.6 GB
    # initial state varies by up to 1.7 s between two restores of one run
    # (2.4-4.1 s), as much as 12 more steps' re-execution
    engine = {s: [] for s in REPLAY_LENGTHS}
    replay = {s: [] for s in REPLAY_LENGTHS}
    for s in REPLAY_LENGTHS:
        fresh = Trainer(cfg, tcfg, eng_run, device=dev, model=model)
        engine[s].append(timed(lambda: fresh.restore(step=s))[1])
        fresh.release()
        del fresh
        torch.cuda.empty_cache()
        rc = InterceptionCheckpointer(ic_run)
        results, st = rc.restore(paths[s], {"step": step_fn}, device=dev)
        replay[s].append(st)
        del results, rc
        torch.cuda.empty_cache()
    rows = {}
    for s in REPLAY_LENGTHS:
        fresh = Trainer(cfg, tcfg, eng_run, device=dev, model=model)
        engine[s].append(timed(lambda: fresh.restore(step=s))[1])
        engine_s = min(engine[s])
        rc = InterceptionCheckpointer(ic_run)
        results, st = rc.restore(paths[s], {"step": step_fn}, device=dev)
        replay[s].append(st)
        first = replay[s][0]["restore_s"]
        st = min(replay[s], key=lambda r: r["restore_s"])
        replayed = rc.replayed_tree(results, "train")
        same = (_tree_equal(replayed["params"], fresh.params)
                and _tree_equal(replayed["opt"], fresh.opt_state))
        if s == REPLAY_LENGTHS[-1]:
            same = same and _tree_equal(replayed["params"], live.params) \
                and _tree_equal(replayed["opt"], live.opt_state)
        rows[s] = dict(engine_s=engine_s, same=same, **st)
        also = " and the live state" if s == REPLAY_LENGTHS[-1] else ""
        log(f"[orch] (d) at step {s}: replay restore_s {st['restore_s']:.3f}"
            f" (load {st['load_s']:.3f} + re-execution {st['replay_s']:.3f}"
            f", replayed_calls {st['replayed_calls']}; the faster of "
            f"{first:.3f} and {replay[s][1]['restore_s']:.3f} s, in turns); "
            f"engine restore "
            f"{engine_s:.3f} s (the faster of {engine[s][0]:.3f} and "
            f"{engine[s][1]:.3f} s, in turns); interception "
            f"checkpoint {ckpt_s[s]:.3f} s ({os.path.getsize(paths[s])} B); "
            f"replay bitwise equal to the engine's restore{also}: {same}; "
            f"{card}")
        fresh.release()
        del fresh, results, replayed, rc
        torch.cuda.empty_cache()
    # wrapped and bare steps in turns, after the checks (the host's noise
    # between two stretches of one call is as large as the effect)
    turns = {"bare": [], "wrapped": []}
    for _ in range(3):
        for kind, fn in (("bare", step_fn), ("wrapped", wrapped)):
            batch = live.pipeline.next()
            _, dt = timed(lambda: fn(live.params, live.opt_state, batch))
            turns[kind].append(dt)
    wrapped_med = sorted(turns["wrapped"])[1]
    bare_med = sorted(turns["bare"])[1]
    logged = sorted(wrapped_s[1:])
    logged_med = logged[len(logged) // 2]
    # whole restores: replay's grows with the log, the engine's reads the
    # same bytes at both steps
    short, long_ = (rows[s] for s in REPLAY_LENGTHS)
    grow = long_["restore_s"] - short["restore_s"]
    engine_grow = long_["engine_s"] - short["engine_s"]
    extra = REPLAY_LENGTHS[-1] - REPLAY_LENGTHS[0]
    log(f"[orch] (d) step in turns: wrapped {wrapped_med * 1e3:.1f} ms, "
        f"bare {bare_med * 1e3:.1f} ms (medians of 3; the logged run's "
        f"wrapped steps {logged_med * 1e3:.1f} ms, the first "
        f"{wrapped_s[0] * 1e3:.1f} ms; intercept_s "
        f"{ic.stats['intercept_s']:.4f} over {ic.stats['intercepted_calls']}"
        f" calls, logged H2D {ic.stats['logged_bytes']} B); registering the "
        f"initial state {register_s:.3f} s; replay's restore_s grew "
        f"{grow:.3f} s over {extra} more calls (its re-execution "
        f"{long_['replay_s'] - short['replay_s']:.3f} s), the engine's "
        f"restore {engine_grow:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B; {card}")
    if not all(r["same"] for r in rows.values()):
        raise SystemExit("orchestration (d): replay did not reproduce the "
                         "state bitwise")
    if not (grow > 0.5 * extra * bare_med
            and abs(engine_grow) < 0.5 * grow):
        raise SystemExit("orchestration (d): replay did not grow with the "
                         "log, or the engine's restore moved as much")
    live.release()
    del live, ic, wrapped
    shutil.rmtree(eng_run)
    shutil.rmtree(ic_run)
    torch.cuda.empty_cache()

    run = os.path.join(workdir, "intercept_scenario")
    summary = run_scenario("preemption", run, device=dev,
                           total_steps=ORCH_TRAIN_STEPS, kind="intercept")
    ref = InterceptionWorkload(JobSpec("ref", kind="intercept",
                                       total_steps=ORCH_TRAIN_STEPS),
                               os.path.join(workdir, "ref_mlp"), device=dev)
    ref.start()
    while not ref.done:
        ref.run_slice(2)
    same = summary["jobs"]["lo"]["digest"] == ref.digest()
    log(f"[orch] (d) intercept scenario (the MLP): all done "
        f"{summary['all_done']}, lo restarts "
        f"{summary['jobs']['lo']['restarts']}, bitwise equal to an "
        f"uninterrupted run: {same}; {card}")
    if not (summary["all_done"] and same):
        raise SystemExit("orchestration (d): the intercept scenario failed")
    return launches


def orch_fleet(dev, w, workdir, card) -> tuple:
    """(e) One serving image fans out to FLEET_REPLICAS replicas over
    FLEET_HOSTS hosts with lazy boot: every replica's tokens equal the
    solo server's, a host's second replica ships under 5% of its first's
    bytes; then a short trace scales up and drains."""
    import numpy as np
    from repro_torch.orchestrator import FleetConfig, ServingFleet

    run = os.path.join(workdir, "fleet")
    _zero_counters()
    t0 = time.perf_counter()
    fleet = ServingFleet(run, FleetConfig(
        replicas=FLEET_REPLICAS, hosts=FLEET_HOSTS, restore_mode="lazy",
        batch=w.serve_batch, prompt_len=w.prompt_len, warm_tokens=4,
        max_seq=w.max_seq, scale_up_depth=2, drain_idle_ticks=1,
        min_replicas=1, workload=w), device=dev)
    img = fleet.build_source_image()
    fleet.boot_fleet()
    served = [rep.server.decode(4).copy() if rep.status == "serving"
              else None for rep in fleet.replicas]
    stats = fleet.serve_trace(FLEET_TRACE)
    wall = time.perf_counter() - t0
    launches = path_launches(w.model_config(), ORCH_KERNELS, "orch")
    # the reference: the solo server decodes on from the image's position
    solo = fleet.source.decode(5).copy()
    exact = [t is not None and np.array_equal(t, solo) for t in served]
    for rep in fleet.replicas:
        b = rep.recovery.breakdown()[0]
        log(f"[orch] (e) replica {rep.rid} on {rep.host}: TTFT "
            f"{rep.ttft_s:.3f} s (transfer {b['transfer_s']:.3f}, restore "
            f"to resume {b['restore_s']:.3f}, first token "
            f"{b['replay_s']:.3f}), bytes_sent {rep.transfer['bytes_sent']},"
            f" chunks reused {rep.transfer['chunks_reused']}; {card}")
    by_host = {}
    for rep in fleet.replicas:
        by_host.setdefault(rep.host, []).append(rep.transfer["bytes_sent"])
    second_ok = all(len(v) > 1 and v[1] < 0.05 * v[0]
                    for v in by_host.values())
    s = fleet.summary()
    log(f"[orch] (e) fleet: image {img['bytes']} B at pos {img['step']}; "
        f"{len(fleet.replicas)} replicas; bytes sent by host "
        f"{by_host}; TTFT p50 {s['ttft_p50_s']:.3f} s; trace {FLEET_TRACE}:"
        f" served {stats['requests_served']}, unserved "
        f"{stats['requests_unserved']}, autoscale boots "
        f"{stats['autoscale_boots']}, drains {stats['drains']}, goodput "
        f"{stats['goodput_requests_per_replica_tick']:.3f} requests per "
        f"replica-tick; wall {wall:.1f} s; every replica"
        f" token-exact: {all(exact)}; {card}")
    if not (all(exact) and second_ok):
        raise SystemExit("orchestration (e): a replica diverged or a host's "
                         "second replica shipped 5% or more of its first's")
    if not (stats["requests_unserved"] == 0 and stats["autoscale_boots"] >= 1
            and stats["drains"] >= 1):
        raise SystemExit(f"orchestration (e): the trace did not scale up and "
                         f"drain: {stats}")
    del fleet
    shutil.rmtree(run)
    return launches


ORCH_PARTS = (("(a) preempt", orch_preemption), ("(b) failure", orch_failure),
              ("(c) migrate", orch_migration), ("(d) replay", orch_replay),
              ("(e) fleet", orch_fleet))


def phase_orchestration(seed: int, workdir: str, card: str,
                        layers: int = ORCH_LAYERS) -> dict:
    """Phase 6: the orchestrator, the interception baseline and the fleet
    on qwen1.5-0.5b at full width, at `layers` of its 24 layers ((d) at
    REPLAY_LAYERS).  Each part returns its path's launches:
    the kernels' counters are zeroed just before its orchestrated run (the
    scenario, the logged training run, the fleet) and read just after,
    before any reference run, replay or timing.  Returns {path:
    (launches, variants)}."""
    import gc
    import torch
    dev = torch.device("cuda")
    w = _orch_workload(layers)
    w_replay = _orch_workload(REPLAY_LAYERS)
    out = {}
    t_phase = time.perf_counter()
    for name, part in ORCH_PARTS:
        sub = os.path.join(workdir, name.split()[0].strip("()"))
        os.makedirs(sub)
        t0 = time.perf_counter()
        if part is orch_replay:
            res = part(dev, w_replay, sub, card, seed)
        else:
            res = part(dev, w, sub, card)
        out[f"{ORCH_ARCH} orchestration {name}"] = res
        log(f"[orch] {name}: {time.perf_counter() - t0:.1f} s; {card}")
        shutil.rmtree(sub, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[orch] phase 6 wall {time.perf_counter() - t_phase:.1f} s; {card}")
    return out


def run_orchestration(seed: int) -> dict:
    """`phase_orchestration` in a child process (its dumps' pinned host
    buffers go back to the OS when it exits), waited for; its paths'
    launches."""
    res = run_child("phase 6", orchestrate, seed)
    return {k: tuple(v) for k, v in res.items()}


# ----------------------------------------------------------------- phase 7
# the README's campaign: 100 sim jobs over 20 simulated hosts, seed 0, one
# event of every fault class (the reference's orchestrator config)
CHAOS_FLEET = ["--jobs", "100", "--hosts", "20", "--seed", "0",
               "--faults", "all=1"]
CHAOS_JOBS = 100
CHAOS_CLASSES = {"sync": 11, "concurrent": 12}    # dirty_burst: concurrent
# tests/test_chaos.py's reproduction campaign: seed 21 twice, then 22
CHAOS_REPRO = dict(jobs=5, hosts=2,
                   faults="commit_kill=1,signal_dup=1,host_kill=1")
CHAOS_ROW = ("planned", "targets", "injected", "recovered", "healed",
             "quarantined")


def _cli(*argv) -> tuple:
    """``repro_torch.cli.main(argv)`` in this process (a ``python -m``
    process would pay torch's import again): its exit code and what it
    printed on stdout."""
    import io
    from repro_torch.cli import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(list(argv))
    return rc, buf.getvalue()


def _check_cli(what: str, rc: int, want: int = 0) -> None:
    if rc != want:
        raise SystemExit(f"phase 7: {what} exited {rc}, not {want}")


def _fingerprint(out: str) -> str:
    (line,) = [ln for ln in out.splitlines() if ln.startswith("fingerprint:")]
    return line.split()[1]


def _stable_rows(rows: dict) -> dict:
    return {c: {k: r[k] for k in CHAOS_ROW} for c, r in rows.items()}


def chaos_sweep(run: str, card: str) -> dict:
    """(a): the README's campaign on the card through the CLI, both
    capture modes; every planned fault injected, the invariant held,
    every dirty_burst a flipped byte of a CUDA tensor that the validate
    pause re-captured, every recovered job's digest its unfaulted replay
    on the card.  Returns the report."""
    import glob
    from repro_torch.chaos.campaign import make_specs
    from repro_torch.chaos.sim import reference_digest
    from repro_torch.obs import export
    t0 = time.perf_counter()
    rc, out = _cli("chaos-campaign", run, *CHAOS_FLEET, "--capture", "sweep",
                   "--json", run + ".metrics.json",
                   "--report", run + ".report.json")
    wall = time.perf_counter() - t0
    _check_cli("chaos-campaign --capture sweep", rc)
    with open(run + ".report.json") as f:
        rep = json.load(f)
    for mode, n_classes in CHAOS_CLASSES.items():
        r = rep[mode]
        rows = r["rows"]
        injected = sum(row["injected"] for row in rows.values())
        planned = sum(row["planned"] for row in rows.values())
        if not r["ok"] or len(rows) != n_classes or injected != planned:
            raise SystemExit(f"phase 7 (a) {mode}: ok {r['ok']}, "
                             f"{len(rows)} classes, {injected}/{planned} "
                             f"injected; violations {r['violations'][:3]}")
        log(f"[chaos] (a) {mode}: {CHAOS_JOBS} jobs x 20 hosts, wall_s "
            f"{r['wall_s']:.3f}, {r['ticks']} ticks, {injected}/{planned} "
            f"faults injected over {n_classes} classes, invariant held; "
            f"{card}")
        for cls, row in sorted(rows.items()):
            mttr = "-" if row["mttr_s"] is None else f"{row['mttr_s']:.4f}"
            log(f"[chaos]   {mode} {cls}: injected {row['injected']}/"
                f"{row['planned']}, recovered {row['recovered']}, healed "
                f"{row['healed']}, quarantined {row['quarantined']}, "
                f"MTTR {mttr} s")
    if "dirty_burst" not in rep["concurrent"]["rows"]:
        raise SystemExit("phase 7 (a): the concurrent campaign planned no "
                         "dirty_burst")
    conc = os.path.join(run, "concurrent")
    bursts = [e for e in export.load_journal(conc)
              if e.get("cls") == "fault" and e.get("kind") == "dirty_burst"]
    if len(bursts) != rep["concurrent"]["rows"]["dirty_burst"]["injected"]:
        raise SystemExit(f"phase 7 (a): {len(bursts)} dirty_burst records "
                         f"in the journal")
    for b in bursts:
        found = glob.glob(os.path.join(
            conc, "**", f"job_{b['job']}", "snapshots",
            f"step_{b['step']:08d}", "MANIFEST.json"), recursive=True)
        if not str(b.get("device", "")).startswith("cuda") or not found:
            raise SystemExit(f"phase 7 (a): dirty_burst {b} did not flip a "
                             f"CUDA tensor of a committed image")
        with open(found[0]) as f:
            cs = json.load(f)["capture_stats"]
        if cs["recaptured_entries"] < 1:
            raise SystemExit(f"phase 7 (a): dirty_burst {b['key']} of "
                             f"{b['job']} was not re-captured: {cs}")
        log(f"[chaos] (a) dirty_burst on {b['job']} step {b['step']}: "
            f"{b['key']} on {b['device']}; dirty {cs['dirty_entries']}, "
            f"re-captured {cs['recaptured_entries']} entries "
            f"({cs['recaptured_bytes']:.0f} B), validate pause "
            f"{cs['validate_pause_s'] * 1e3:.2f} ms")
    refs = {s.job_id: reference_digest(s, "cuda")
            for s in make_specs(CHAOS_JOBS)}
    n_rec = 0
    for mode in CHAOS_CLASSES:
        for job, outcome in rep[mode]["outcomes"].items():
            if outcome == "recovered":
                n_rec += 1
                if rep[mode]["digests"][job] != refs[job]:
                    raise SystemExit(f"phase 7 (a) {mode}: {job}'s digest "
                                     f"is not its replay on the card")
    log(f"[chaos] (a) sweep through the CLI {wall:.2f} s (journal on); "
        f"{n_rec} recovered jobs' digests equal their unfaulted replays on "
        f"the card; fingerprint {_fingerprint(out)[:16]}; {card}")
    return rep


def phase_chaos(workdir: str, card: str) -> dict:
    """Phase 7: chaos campaigns, the observability plane and the CLI,
    driven in-process through ``repro_torch.cli.main``.  (a) the
    README's sweep on the card; (b) the sync campaign on the CPU, whose
    rows and outcomes must be the card's; (c) same seed, same
    fingerprint on the card, another seed another; (d) ``trace``,
    ``events``, ``metrics`` and ``validate_journal`` on (a)'s sync
    journal; (e) ``inspect``, ``verify`` (then a torn pack: exit 1) on a
    job image of (a), ``check --device cuda``, and the leftover-bytes
    warning of a frozen capture on the card.  The sim launches no
    kernel: the counters, zeroed just before (a) and read just after,
    must stay at 0.  The campaigns' seeds are the reference's (0, 21,
    22), not ``--seed``.  Returns {path: (launches, variants)}."""
    import torch
    from repro_torch.chaos.campaign import run_campaign
    from repro_torch.obs import export
    t_phase = time.perf_counter()
    run = os.path.join(workdir, "fleet")
    _zero_counters()
    rep = chaos_sweep(run, card)
    launches = {name: mod.launches for name, mod in _counters().items()}
    variants = _variants()
    if any(launches.values()):
        raise SystemExit(f"phase 7: the campaign launched kernels: "
                         f"{launches}")

    journals = [os.path.join(run, m) for m in CHAOS_CLASSES]
    n_events = sum(len(export.load_journal(j)) for j in journals)
    n_bytes = sum(os.path.getsize(os.path.join(j, "obs", "journal.jsonl"))
                  for j in journals)
    log(f"[chaos] (a) the journals: {n_events} events, {n_bytes} B "
        f"(tools/chaos_trace_ab.py times the sweep without them); {card}")

    t0 = time.perf_counter()
    cpu = run_campaign(os.path.join(workdir, "cpu"), jobs=CHAOS_JOBS,
                       hosts=20, seed=0, faults="all=1", capture="sync",
                       device="cpu")
    card_sync = rep["sync"]
    if not cpu.ok or _stable_rows(cpu.rows) != \
            _stable_rows(card_sync["rows"]) or \
            cpu.outcomes != card_sync["outcomes"]:
        raise SystemExit("phase 7 (b): the CPU campaign's rows or outcomes "
                         "differ from the card's")
    same = sum(cpu.digests[j] == card_sync["digests"][j]
               for j in cpu.digests)
    log(f"[chaos] (b) the sync campaign on the CPU: wall_s "
        f"{cpu.wall_s:.3f} ({time.perf_counter() - t0:.2f} s in all), "
        f"{cpu.ticks} ticks; rows and per-job outcomes equal to the card's; "
        f"{same}/{CHAOS_JOBS} final digests bit-equal across the two "
        f"devices (the card's sin rounds its own way); {card}")
    shutil.rmtree(os.path.join(workdir, "cpu"))

    fps = []
    for name, s in (("a", 21), ("b", 21), ("c", 22)):
        r = run_campaign(os.path.join(workdir, f"repro_{name}"), seed=s,
                         device="cuda", **CHAOS_REPRO)
        if not r.ok:
            raise SystemExit(f"phase 7 (c): seed {s}: {r.violations}")
        fps.append(r.fingerprint())
    if fps[0] != fps[1] or fps[2] == fps[0]:
        raise SystemExit(f"phase 7 (c): fingerprints {fps}")
    log(f"[chaos] (c) seed 21 twice on the card: {fps[0][:16]} both; seed "
        f"22: {fps[2][:16]}; {card}")

    sync_run = os.path.join(run, "sync")
    rc, text = _cli("trace", sync_run, "--chrome")
    _check_cli("trace --chrome", rc)
    with open(os.path.join(sync_run, "obs", "trace.json")) as f:
        chrome = json.load(f)
    injected = sum(r["injected"] for r in card_sync["rows"].values())
    rc, text = _cli("events", sync_run, "--class", "fault", "--json")
    _check_cli("events --class fault", rc)
    rows = [json.loads(ln) for ln in text.splitlines()]
    rc, text = _cli("metrics", sync_run, "--json")
    _check_cli("metrics --json", rc)
    flat = json.loads(text)
    problems = export.validate_journal(export.load_journal(sync_run))
    if (len(rows) != injected or flat["obs.counter.chaos.injections"]
            != injected or problems or not chrome["traceEvents"]):
        raise SystemExit(f"phase 7 (d): {len(rows)} fault rows, counter "
                         f"{flat.get('obs.counter.chaos.injections')}, "
                         f"{injected} injected; problems {problems[:3]}")
    log(f"[cli] (d) trace --chrome: {len(chrome['traceEvents'])} trace "
        f"events; events --class fault: {len(rows)} rows; metrics: "
        f"chaos.injections {flat['obs.counter.chaos.injections']:.0f} of "
        f"{injected} injected, {len(flat)} metrics; validate_journal: no "
        f"problems; {card}")

    job = sorted(j for j, o in card_sync["outcomes"].items()
                 if o == "recovered")[0]
    image = next(d for d in sorted(Path(sync_run).glob(f"host*/job_{job}"))
                 if (d / "snapshots").is_dir())
    rc, _ = _cli("inspect", str(image))
    _check_cli("inspect", rc)
    rc, _ = _cli("verify", str(image))
    _check_cli("verify", rc)
    newest = sorted((image / "snapshots").glob("step_*"))[-1]
    with open(newest / "host0000.pack.0", "r+b") as f:
        f.seek(40)
        f.write(b"\xde\xad\xbe\xef" * 4)
    rc, text = _cli("verify", str(image))
    _check_cli("verify of a torn pack", rc, want=1)
    rc, text_check = _cli("check", "--device", "cuda")
    _check_cli("check --device cuda", rc)
    probe = [ln.strip() for ln in text_check.splitlines()
             if "device probe" in ln]
    from repro_torch.api import CheckpointSession
    state = {"w": torch.ones(1024, device="cuda")}
    scratch = torch.empty(1 << 20, device="cuda")      # outside the roots
    sess = CheckpointSession(os.path.join(workdir, "frozen"), device="cuda")
    sess.attach(lambda: {"st": state})
    with sess.frozen(1) as snap:
        warned = [w for w in snap.warnings if "outside the registered" in w]
        if snap.step != 1 or not warned:
            raise SystemExit(f"phase 7 (e): frozen step {snap.step}, "
                             f"warnings {snap.warnings}")
    del scratch
    corrupt = [ln for ln in text.splitlines() if "CORRUPT" in ln][0]
    log(f"[cli] (e) {image.relative_to(run)}: inspect 0, verify 0, verify "
        f"after 16 bytes torn in {newest.name}/host0000.pack.0: 1 "
        f"({corrupt.split(' — ')[0]}); "
        f"check --device cuda 0 ({probe[0] if probe else ''}); a frozen "
        f"capture's warnings carry the leftover device bytes; {card}")
    log(f"[chaos] phase 7 wall {time.perf_counter() - t_phase:.1f} s; {card}")
    return {"chaos campaigns (sim, no kernel)": (launches, variants)}


def chaos() -> dict:
    """Phase 7; its path's launches (none)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        return phase_chaos(workdir, card_line())


# ----------------------------------------------------------------- phase 8
LAUNCH_TRAIN = ["--arch", "whisper-tiny", "--steps", "8", "--ckpt-every",
                "4"]
LAUNCH_FAIL_AT, LAUNCH_RESTORED_AT = 6, 4
LAUNCH_SERVE = ["--arch", "qwen1.5-0.5b", "--batch", "4", "--prompt-len",
                "512", "--max-seq", "1024", "--tokens", "32"]
LAUNCH_SNAPSHOT_AT = 16
# qwen1.5-0.5b at full width, cut to 1 of its 24 layers for the run's
# time budget: tools/cut_ab.py measured 4 -> 1 layers at -8.4 s (H100);
# the embedding (155.6 M of the 4 layers' 207 M params) stays
ELASTIC_ARCH, ELASTIC_LAYERS = "qwen1.5-0.5b", 1
ELASTIC_PATH = "elastic"       # --path: phase 8 (c) alone (tools/cut_ab.py)
ELASTIC_STEP = 3
ELASTIC_MESHES = {"4x2": (4, 2), "2x2": (2, 2), "1x1": (1, 1)}
LAUNCH_KERNELS = ("flash_attention", "rmsnorm")


def _launcher(module: str, argv: list) -> dict:
    """One launcher run in this (child) process: ``main(argv)`` of
    ``repro_torch.launch.<module>`` (see `_captured`)."""
    import importlib
    main_fn = importlib.import_module(f"repro_torch.launch.{module}").main
    return _captured(main_fn, list(argv))


def _captured(fn, *args) -> dict:
    """``fn(*args)`` in this (child) process: its exit code, what it
    printed and its JSON, and the kernels' launches over the run
    (counters zeroed just before it)."""
    import io
    out, err = io.StringIO(), io.StringIO()
    _zero_counters()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*args)
    launches = {name: mod.launches for name, mod in _counters().items()}
    text = out.getvalue()
    start = text.find("{\n")
    return {"rc": rc, "out": text, "err": err.getvalue()[-2000:],
            "json": json.loads(text[start:]) if start >= 0 else None,
            "launches": launches, "variants": _variants()}


def _launch_run(what: str, module: str, argv: list, want_rc: int = 0
                ) -> dict:
    """A launcher run in a child process of its own (forked from the fork
    server: no torch import), its exit code checked; the launch kernels
    and the tensor-core flash variant alone must have run."""
    res = run_child(what, _launcher, module, argv)
    if res["rc"] != want_rc:
        raise SystemExit(f"phase 8 {what}: exit {res['rc']}, not {want_rc}"
                         f"\n{res['out'][-2000:]}\n{res['err']}")
    _check_kernels(what, res["launches"], res["variants"])
    return res


def _check_kernels(what: str, launches: dict, variants: dict) -> None:
    missing = [k for k in LAUNCH_KERNELS if launches[k] <= 0]
    if missing or variants["flash_attention"]["fma"]:
        raise SystemExit(f"phase 8 {what}: launches {launches}, flash "
                         f"variants {variants['flash_attention']}")


def _merge_launches(runs) -> tuple:
    """One path's launches and variants over several processes."""
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    variants = {}
    for name in VARIANT_KERNELS:
        vs = [r["variants"][name] for r in runs]
        variants[name] = {
            "tc": sum(v["tc"] for v in vs), "fma": sum(v["fma"] for v in vs),
            "served": {k: [s for v in vs for s in v["served"][k]]
                       for k in ("tc", "fma")}}
    return launches, variants


def launch_train_part(workdir: str, card: str) -> tuple:
    """(a): the train launcher, whisper-tiny at full width, uncut:
    uninterrupted, crashed at step 6 (exit 1), restored from the step-4
    image in a fresh process; the final losses equal bitwise."""
    base = LAUNCH_TRAIN + ["--device", "cuda"]
    run_a = os.path.join(workdir, "train_a")
    run_b = os.path.join(workdir, "train_b")
    ref = _launch_run("(a) train uninterrupted", "train",
                      base + ["--run-dir", run_a])
    crash = _launch_run("(a) train --fail-at", "train",
                        base + ["--run-dir", run_b, "--fail-at",
                                str(LAUNCH_FAIL_AT)], want_rc=1)
    image = _image_bytes(os.path.join(run_b, "snapshots",
                                      f"step_{LAUNCH_RESTORED_AT:08d}"))
    back = _launch_run("(a) train --restore", "train",
                       base + ["--run-dir", run_b, "--restore"])
    if f"at step {LAUNCH_RESTORED_AT}" not in back["out"]:
        raise SystemExit(f"phase 8 (a): the restore did not report step "
                         f"{LAUNCH_RESTORED_AT}:\n{back['out'][-1000:]}")
    a, b = ref["json"], back["json"]
    if a["final_loss"] != b["final_loss"] or a["steps"] != b["steps"]:
        raise SystemExit(f"phase 8 (a): final loss {b['final_loss']!r} "
                         f"after the restore, {a['final_loss']!r} "
                         f"uninterrupted")
    steps = int(LAUNCH_TRAIN[LAUNCH_TRAIN.index("--steps") + 1])
    log(f"[launch] (a) train whisper-tiny (full width, B 8 x 1500 frames, "
        f"seq 64): final loss {a['final_loss']!r} uninterrupted and after "
        f"--fail-at {LAUNCH_FAIL_AT} + --restore (step "
        f"{LAUNCH_RESTORED_AT}): bitwise; {a['wall_s'] / steps * 1e3:.2f} "
        f"ms/step (wall_s {a['wall_s']:.3f} / {steps} steps, two async "
        f"images included); step-{LAUNCH_RESTORED_AT} image {image} "
        f"bytes; cold restore {b['restore_s']:.3f} s; launches flash / "
        f"RMSNorm {ref['launches']['flash_attention']} / "
        f"{ref['launches']['rmsnorm']} (uninterrupted), "
        f"{crash['launches']['flash_attention']} / "
        f"{crash['launches']['rmsnorm']} (crashed), "
        f"{back['launches']['flash_attention']} / "
        f"{back['launches']['rmsnorm']} (restored); {card}")
    return _merge_launches([ref, crash, back])


def launch_serve_part(workdir: str, card: str) -> tuple:
    """(b): the serve launcher, qwen1.5-0.5b at full width, uncut:
    uninterrupted, with a snapshot at token 16, restored in a fresh
    process; the generated tokens equal the uninterrupted run's."""
    base = LAUNCH_SERVE + ["--device", "cuda"]
    run_a = os.path.join(workdir, "serve_a")
    run_b = os.path.join(workdir, "serve_b")
    ref = _launch_run("(b) serve uninterrupted", "serve",
                      base + ["--run-dir", run_a])
    snap = _launch_run("(b) serve --snapshot-at", "serve",
                       base + ["--run-dir", run_b, "--snapshot-at",
                               str(LAUNCH_SNAPSHOT_AT)])
    back = _launch_run("(b) serve --restore", "serve",
                       base + ["--run-dir", run_b, "--restore"])
    want = ref["json"]["tokens_sha256"]
    for what, r in (("snapshot run", snap), ("restored run", back)):
        if r["json"]["tokens_sha256"] != want:
            raise SystemExit(f"phase 8 (b): the {what}'s tokens differ "
                             f"from the uninterrupted run's")
    t, ts = ref["json"]["timings"], snap["json"]["timings"]
    image = _image_bytes(os.path.join(run_b, "snapshots", "step_00000000"))
    log(f"[launch] (b) serve qwen1.5-0.5b (full width, B 4 x 512, 32 "
        f"tokens): {back['json']['generated']} tokens token-exact after "
        f"--snapshot-at {LAUNCH_SNAPSHOT_AT} + --restore; prefill "
        f"{t['prefill_s'] * 1e3:.1f} ms, decode "
        f"{t['decode_s_per_token'] * 1e3:.2f} ms/token; freeze "
        f"{ts['freeze_s'] * 1e3:.1f} ms, checkpoint {ts['checkpoint_s']:.3f}"
        f" s, image {image} bytes; restore "
        f"{back['json']['timings']['restore_s']:.3f} s; launches flash / "
        f"RMSNorm {ref['launches']['flash_attention']} / "
        f"{ref['launches']['rmsnorm']} (uninterrupted); {card}")
    return _merge_launches([ref, snap, back])


def _elastic_model(dev, layers: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config(ELASTIC_ARCH), num_layers=layers)
    return cfg, LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
                   device=dev)


def elastic_train(run: str, seed: int, layers: int) -> dict:
    """(c), first process: train on a (4, 2) mesh of card slots with a
    sync image at step 3; the uninterrupted step 4's state is saved raw
    (``torch.save``: the reference the next process compares with, at a
    fraction of an image's CRC and restore time)."""
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.trainer import Trainer
    dev = torch.device("cuda")
    cfg, model = _elastic_model(dev, layers)
    mesh = make_mesh(ELASTIC_MESHES["4x2"], ("data", "model"), devices=dev)
    tcfg = _train_config(TRAIN_B, TRAIN_S, seed,
                         ckpt=CheckpointOptions(mode="sync", keep=0))
    t = Trainer(cfg, tcfg, run, model=model, mesh=mesh)
    t.initialize()
    _zero_counters()
    t.run(ELASTIC_STEP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.session.checkpoint(ELASTIC_STEP)
    dump_s = time.perf_counter() - t0
    t.run(1)
    launches = {name: mod.launches for name, mod in _counters().items()}
    from repro_torch.core.device_plugin import flatten_with_paths
    torch.save({k: v.cpu() for k, v in flatten_with_paths(
        {"params": t.params, "opt": t.opt_state}).items()},
        _uninterrupted(run))
    state_bytes = sum(x.numel() * x.element_size() for x in _leaves(
        {"p": t.params, "m": t.opt_state.m, "v": t.opt_state.v})) + 4
    return {"launches": launches, "variants": _variants(),
            "dump_s": dump_s, "state_bytes": state_bytes}


def _uninterrupted(run: str) -> str:
    return os.path.join(os.path.dirname(run), "step4.pt")


def elastic_check(run: str, seed: int, layers: int) -> dict:
    """(c), second process: ``elastic_restore`` of the step-3 image onto
    (4, 2) ("identical"), then onto (2, 2) and (1, 1) ("resharded"), each
    bit-equal to the first; one step from each restored state equals the
    uninterrupted step 4 bitwise, which holds the first restore to the
    saved state."""
    import torch
    from repro_torch.api import CheckpointSession
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.runtime.trainer import Trainer
    dev = torch.device("cuda")
    cfg, model = _elastic_model(dev, layers)
    tcfg = _train_config(TRAIN_B, TRAIN_S, seed)
    opt = AdamW(lr=warmup_cosine(tcfg.lr, tcfg.warmup_steps,
                                 tcfg.total_steps))

    man = CheckpointSession(run, device=dev).store.reader(ELASTIC_STEP)
    meta = man.meta["train_state"]
    blocks = sum(len(m.get("shards", ())) for m in meta.values())
    payload = sum(int(man.entry_nbytes("train_state", p)) for p in meta)
    man.close()
    nxt = torch.load(_uninterrupted(run), map_location=dev)
    out = {"blocks": blocks, "entries": len(meta), "payload": payload,
           "modes": {}, "restore_s": {}}
    runs, saved = [], None
    for name in ("4x2", "2x2", "1x1"):
        shape = ELASTIC_MESHES[name]
        mesh = (make_host_mesh(device=dev) if shape == (1, 1)
                else make_mesh(shape, ("data", "model"), devices=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = elastic_restore(run, mesh, model, opt, step=ELASTIC_STEP)
        torch.cuda.synchronize()
        out["restore_s"][name] = time.perf_counter() - t0
        out["modes"][name] = got["topology_mode"]
        flat = flatten_with_paths({"params": got["params"],
                                   "opt": got["opt"]})
        if saved is None:            # the step below updates in place
            saved = {k: v.clone() for k, v in flat.items()}
        elif flat.keys() != saved.keys() or not all(
                torch.equal(flat[k], saved[k]) for k in saved):
            raise SystemExit(f"phase 8 (c): the {name} restore is not the "
                             f"(4, 2) one")
        t = Trainer(cfg, tcfg, os.path.join(os.path.dirname(run),
                                            f"next_{name}"),
                    model=model, mesh=mesh)
        t.params, t.opt_state, t.step = got["params"], got["opt"], \
            got["step"]
        t.pipeline.restore_state(got["meta"]["cursor"])
        _zero_counters()
        t.run(1)
        runs.append({"launches": {n: m.launches for n, m in
                                  _counters().items()},
                     "variants": _variants()})
        step = flatten_with_paths({"params": t.params, "opt": t.opt_state})
        if not all(torch.equal(step[k], nxt[k]) for k in nxt):
            raise SystemExit(f"phase 8 (c): the step after the {name} "
                             f"restore differs from the uninterrupted one")
        del t, got, step
        torch.cuda.empty_cache()
    out["runs"] = runs
    return out


def launch_elastic_part(workdir: str, seed: int, card: str,
                        layers: int = ELASTIC_LAYERS) -> tuple:
    """(c): a qwen1.5-0.5b training state at full width (`layers` layers)
    moved from a (4, 2) mesh to (2, 2) and (1, 1) by
    ``elastic_restore``."""
    run = os.path.join(workdir, "elastic", "run")
    os.makedirs(os.path.dirname(run))
    first = run_child("(c) train on (4, 2)", elastic_train, run, seed,
                      layers)
    _check_kernels("(c) train", first["launches"], first["variants"])
    res = run_child("(c) elastic restores", elastic_check, run, seed,
                    layers)
    for r in res["runs"]:
        _check_kernels("(c) next step", r["launches"], r["variants"])
    want = {"2x2": "resharded", "1x1": "resharded", "4x2": "identical"}
    if res["modes"] != want:
        raise SystemExit(f"phase 8 (c): topology modes {res['modes']}")
    if res["payload"] != first["state_bytes"]:
        raise SystemExit(f"phase 8 (c): image payload {res['payload']} B, "
                         f"state {first['state_bytes']} B")
    r = res["restore_s"]
    log(f"[launch] (c) elastic qwen1.5-0.5b ({layers} of 24 layers, full "
        f"width) on (4, 2) card slots: step-{ELASTIC_STEP} image "
        f"{res['entries']} entries in {res['blocks']} blocks, "
        f"{res['payload']} B (the state's bytes, as unsharded), sync dump "
        f"{first['dump_s']:.3f} s; restores: (4, 2) identical "
        f"{r['4x2']:.3f} s, (2, 2) resharded {r['2x2']:.3f} s, (1, 1) "
        f"resharded {r['1x1']:.3f} s; bit-equal, and the next step from "
        f"each bitwise the uninterrupted one; "
        f"launches flash / RMSNorm {first['launches']['flash_attention']} "
        f"/ {first['launches']['rmsnorm']} (4 steps on (4, 2)); {card}")
    return _merge_launches([first] + res["runs"])


def phase_launch(seed: int, card: str) -> dict:
    """Phase 8: meshes, elastic restore and the launchers.  Every
    launcher run and each half of (c) is a process of its own, its
    kernels' counters zeroed just before its run.  Returns {path:
    (launches, variants)}."""
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        for name, part, args in (
                ("whisper-tiny train launcher (a)", launch_train_part, ()),
                ("qwen1.5-0.5b serve launcher (b)", launch_serve_part, ()),
                (f"{ELASTIC_ARCH} elastic ({ELASTIC_LAYERS} of 24 layers) "
                 f"(c)",
                 launch_elastic_part, (seed,))):
            t0 = time.perf_counter()
            out[name] = part(workdir, *args, card)
            log(f"[launch] {name}: {time.perf_counter() - t0:.1f} s; "
                f"{card}")
    log(f"[launch] phase 8 wall {time.perf_counter() - t_phase:.1f} s; "
        f"{card}")
    return out


# ----------------------------------------------------------------- phase 9
# the dry run's CLI at full published configs: one cell per arch on the
# pod mesh (one decode step over a 32k cache: each arch's cheapest cell)
# and qwen1.5-0.5b's training cell on the multipod mesh, in one process
DRY_CELLS = [f"{a}/decode_32k/pod" for a in (
    "phi3-medium-14b", "deepseek-coder-33b", "h2o-danube-1.8b",
    "qwen1.5-0.5b", "jamba-v0.1-52b", "whisper-tiny", "mamba2-2.7b",
    "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b", "qwen2-vl-7b")] + [
    "qwen1.5-0.5b/train_4k/multipod"]
# (b)-(c): qwen1.5-0.5b uncut on a (1, 1) mesh at phase 3's training
# shape, its prefill at the same shape and one decode step over phase 8
# (b)'s cache of 1024
DRY_ARCH, DRY_B, DRY_S, DRY_MAX_SEQ = "qwen1.5-0.5b", 4, 512, 1024
DRY_PEAK = (0.5, 2.0)      # modelled peak / max_memory_allocated, bounds
DRY_REPEATS = {"train": 5, "prefill": 5, "decode": 20}   # timed calls
DRY_PATH = f"{DRY_ARCH} dry-run checks (phase 9)"


def _nbytes(tree) -> int:
    from repro_torch.core.device_plugin import flatten_with_paths
    return sum(t.numel() * t.element_size()
               for t in flatten_with_paths(tree).values())


def _ops(trace) -> dict:
    """(op, FLOPs) -> how many times the trace ran it."""
    import collections
    return collections.Counter((r.op, r.flops) for r in trace.records)


def _dry_record(kind: str, seq: int) -> dict:
    """The dry run of one qwen1.5-0.5b cell (uncut config, B = DRY_B) on
    a (1, 1) mesh of meta slots; its trace's ops under "ops"."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeCell
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    cell = ShapeCell(f"phase9_{kind}", kind, seq, DRY_B)
    traced = dr.build_traced(DRY_ARCH, cell, mesh)
    return dict(dr.analyse(traced, 1), ops=_ops(traced.trace))


def _card_flops(model, fn) -> dict:
    """The op analysis of fn() on the card with the plain path
    (``use_kernels=False``), as the meta trace runs it."""
    import torch
    from repro_torch.launch.hlo_analysis import OpTrace, analyze_trace
    model.use_kernels = False
    try:
        trace = OpTrace()
        with trace:
            fn()
        torch.cuda.synchronize()
    finally:
        model.use_kernels = True
    return dict(analyze_trace(trace, 1), ops=_ops(trace))


def _timed_ms(fn, n: int) -> float:
    """Median wall time of fn() on the host's clock, each call waited
    for (a step ends in the host reading its result back)."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _dry_check(kind: str, rec: dict, args_card: int, peak_card: int,
               flops_card: dict, ms: float, card: str) -> list:
    """Log one cell's prediction against the card; the failed checks."""
    mem = rec["memory"]
    modelled = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    ratio = modelled / peak_card
    bound_ms = rec["roofline_bound_s"] * 1e3
    flash_ms = max(rec["t_compute_s"], rec["t_memory_flash_s"],
                   rec["t_collective_s"]) * 1e3
    same = (flops_card["flops_by_kind"] == rec["flops_by_kind"]
            and flops_card["flops"] == rec["flops_per_device"])
    shape = f"cache {DRY_MAX_SEQ}" if kind == "decode" else f"S {DRY_S}"
    log(f"[dryrun] {DRY_ARCH} {kind} (B {DRY_B}, {shape}): arguments "
        f"predicted {mem['argument_size_in_bytes']:.0f} B, on "
        f"the card {args_card} B ({rec['argument_bytes_by_part']}); "
        f"modelled peak {modelled:.0f} B (temp "
        f"{mem['temp_size_in_bytes']:.0f} B) / max_memory_allocated "
        f"{peak_card} B = {ratio:.3f}; FLOPs meta {rec['flops_by_kind']} "
        f"card (use_kernels=False) {flops_card['flops_by_kind']}, equal "
        f"{same}; "
        f"measured {ms:.3f} ms (kernels, host clock) against the bound "
        f"{bound_ms:.3f} ms ({rec['dominant']}; compute "
        f"{rec['t_compute_s'] * 1e3:.3f}, memory "
        f"{rec['t_memory_s'] * 1e3:.3f}, memory with flash "
        f"{rec['t_memory_flash_s'] * 1e3:.3f} ms) = {bound_ms / ms:.4f} "
        f"of the roofline ({flash_ms / ms:.4f} with the flash memory "
        f"term); {card}")
    bad = []
    if args_card != mem["argument_size_in_bytes"]:
        bad.append(f"{kind} argument bytes")
    if not DRY_PEAK[0] <= ratio <= DRY_PEAK[1]:
        bad.append(f"{kind} modelled peak {ratio:.3f}")
    if not same:
        bad.append(f"{kind} FLOPs")
        log(f"[dryrun] {kind}: (op, FLOPs) on the card only "
            f"{dict(flops_card['ops'] - rec['ops'])}, in the meta trace "
            f"only {dict(rec['ops'] - flops_card['ops'])}")
    return bad


def dryrun_train(seed: int, workdir: str, card: str) -> list:
    """(b): qwen1.5-0.5b's train step, the dry run against a real
    Trainer's on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer
    rec = _dry_record("train", DRY_S)
    cfg = get_config(DRY_ARCH)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
               device=dev)                               # remat=True
    t = Trainer(cfg, _train_config(DRY_B, DRY_S, seed),
                os.path.join(workdir, "train"), device=dev, model=model)
    t.initialize()
    # the pipeline's batch as it makes it (int32 tokens: the dry run's
    # batch spec, as the reference's)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in t.pipeline.peek(0).items()}
    args_card = _nbytes(t.params) + _nbytes(t.opt_state) + _nbytes(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t._train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = _timed_ms(lambda: t._train_step(batch), DRY_REPEATS["train"])
    flops = _card_flops(model, lambda: t._train_step(batch))
    bad = _dry_check("train step", rec, args_card, peak, flops, ms, card)
    t.release()
    return bad


def dryrun_serve(seed: int, card: str) -> list:
    """(c): qwen1.5-0.5b's prefill and one decode step, the dry run
    against the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models.lm import LM
    cfg = get_config(DRY_ARCH)
    dev = torch.device("cuda")
    bad = []
    for kind in ("prefill", "decode"):
        rec = _dry_record(kind, DRY_S if kind == "prefill" else DRY_MAX_SEQ)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
                   device=dev)
        params = model.init(seed)
        if kind == "prefill":
            batch = {k: torch.as_tensor(v).to(dev) for k, v in TokenPipeline(
                cfg, DRY_B, DRY_S, seed=seed).peek(0).items()}
            args_card = _nbytes(params) + _nbytes(batch)
            fn = lambda: model.prefill(params, batch)  # noqa: E731
        else:
            cache = model.init_cache(DRY_B, DRY_MAX_SEQ)
            tokens = torch.arange(DRY_B, dtype=torch.int32, device=dev)
            args_card = _nbytes(params) + _nbytes(cache) + _nbytes(tokens)
            fn = lambda: model.decode_step(  # noqa: E731
                params, cache, tokens, DRY_MAX_SEQ - 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = _timed_ms(fn, DRY_REPEATS[kind])
        flops = _card_flops(model, fn)
        bad += _dry_check(kind, rec, args_card, peak, flops, ms, card)
        del model, params, fn
        torch.cuda.empty_cache()
    return bad


def dryrun_phase(seed: int) -> dict:
    """Phase 9 (b)-(c): the train step, the prefill and one decode step of
    qwen1.5-0.5b, each predicted on a (1, 1) mesh and held against the
    card: argument bytes to the byte, the modelled peak within DRY_PEAK
    of max_memory_allocated, the analyzer's FLOPs of the plain path on
    the card equal to the meta trace's, and the time with the kernels
    beside the roofline bound.  Returns {path: (launches, variants)}."""
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        _zero_counters()
        bad = dryrun_train(seed, workdir, card)
        bad += dryrun_serve(seed, card)
        launches = {n: m.launches for n, m in _counters().items()}
        variants = _variants()
    missing = [k for k in LAUNCH_KERNELS if launches[k] <= 0]
    if missing or variants["flash_attention"]["fma"]:
        bad.append(f"launches {launches}")
    log(f"[dryrun] (b)-(c) launches {launches}; {card}")
    if bad:
        raise SystemExit(f"phase 9 (dry run) failed: {bad}")
    return {DRY_PATH: (launches, variants)}


class DryrunCLI:
    """Phase 9 (a): ``python -m repro_torch.launch.dryrun`` over DRY_CELLS
    in a process of its own (no card: every slot on the meta device).
    The whole script starts it first, so it runs beside phases 1-8 and
    costs phase 9 only its wait; ``--dryrun`` starts it beside (b)-(c).
    ``check`` waits for it, prints each cell's summary and fails on a bad
    exit, a missing cell or a record not ok; ``stop`` kills it if it
    still runs and removes its directory."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        self.out = os.path.join(self.dir, "dryrun_torch")
        self.log_path = os.path.join(self.dir, "cli.log")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--out", self.out] + [a for c in DRY_CELLS
                                     for a in ("--cell", c)]
        env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
        self.t0 = time.time()
        with open(self.log_path, "w") as logf:
            self.proc = subprocess.Popen(cmd, stdout=logf,
                                         stderr=subprocess.STDOUT, env=env)

    def check(self, card: str) -> None:
        t_wait = time.perf_counter()
        rc = self.proc.wait(timeout=900)
        # its wall time: from its start to its log's last write
        wall = os.path.getmtime(self.log_path) - self.t0
        with open(self.log_path) as f:
            out = f.read()
        recs = []
        for c in DRY_CELLS:
            arch, shape, mk = c.split("/")
            path = os.path.join(self.out,
                                f"{arch}__{shape}__{mk}__baseline.json")
            if os.path.exists(path):
                with open(path) as f:
                    recs.append(json.load(f))
        for r in recs:
            m = r["memory"]
            log(f"[dryrun] cli {r['arch']} {r['shape']} {r['mesh']} "
                f"({r['n_devices']} H100 slots, predicted): dominant "
                f"{r['dominant']}, compute {r['t_compute_s']:.6f} s, memory "
                f"{r['t_memory_s']:.6f} s (flash {r['t_memory_flash_s']:.6f}"
                f"), collective {r['t_collective_s']:.6f} s, arguments "
                f"{m['argument_size_in_bytes'] / 2**30:.3f} GiB + temp "
                f"{m['temp_size_in_bytes'] / 2**30:.3f} GiB per slot, fits "
                f"{r['fits']}, traced in {r['trace_s']:.2f} s")
        log(f"[dryrun] cli: {len(recs)} of {len(DRY_CELLS)} cells in one "
            f"process, exit {rc}, {wall:.1f} s wall, waited for "
            f"{time.perf_counter() - t_wait:.1f} s; {card}")
        if rc != 0 or len(recs) != len(DRY_CELLS) or not all(
                r.get("ok") for r in recs) or out.count(
                "memory_analysis:") != len(DRY_CELLS):
            log(out[-3000:])
            raise SystemExit("phase 9 (dry run) failed: the dry run's CLI")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def run_dryrun(seed: int, cli: DryrunCLI, card: str) -> dict:
    """Phase 9: (b)-(c) in a child process, waited for, then (a)'s
    check; (b)-(c)'s path's launches."""
    t_phase = time.perf_counter()
    res = run_child("phase 9", dryrun_phase, seed)
    cli.check(card)
    log(f"[dryrun] phase 9 wall {time.perf_counter() - t_phase:.1f} s; "
        f"{card}")
    return {k: tuple(v) for k, v in res.items()}


# ---------------------------------------------------------------- phase 10
# the decoder zoo trained at published widths (bf16 compute over f32
# masters, remat, kernels), depth cut for the card's 80 GB and the run's
# time budget: (arch, layers, B, S, crash-and-restore, grad tolerance:
# below).  qwen3-moe at 1 of 48 layers is 1.25 B params (622 M embedding
# and untied head, 623 M a layer), ~14.9 GB of params + AdamW in its
# image: at 2 layers its 22.4 GB image took 34.0-37.8 s to write and
# 45.2-47.0 s to restore in a whole run (H100 80GB HBM3, 700 W), which
# the phase 5 and 6 cuts did not pay for on a slow host; danube's 4608 tokens put the 4096 window over the last 512
# queries' oldest keys; qwen2-vl's 1280 are 1024 vision embeddings + 256
# text tokens (phase 2c's shape), and its state (1.32 B params) is a
# dense decoder's, imaged in phase 3.  phi3-medium-14b at 2 of 40 layers
# (1.71 B params, 1.03 B of them the untied 100352-row embedding and
# head: ~27.3 GB of params, AdamW and grads) runs twice from one seed
# with no image: its params' image is phase 2b's serving one.
# deepseek-coder-33b at 1 of 62 (0.99 B params; a GQA group of 7, d 7168
# RMSNorm rows, an untied 32256-row head) takes the crash path with an
# ~11.9 GB image.  qwen3-moe-235b-a22b at 1 of 94 (3.73 B params, 2.42 B
# of them its 128 experts; 44.8 GB of f32 params and AdamW state, the
# dry run's peak 70.63 GiB) runs twice from one seed with no image (12 B
# a param would be ~44.8 GB; its params' image is phase 2b's), alone on
# the card (ZOO_TRAIN_ALONE)
ZOO_TRAIN = (("qwen3-moe-30b-a3b", 1, 4, 512, True, 0.002),
             ("h2o-danube-1.8b", 2, 1, 4608, True, 0.25),
             ("qwen2-vl-7b", 1, 2, 1280, False, 0.006),
             ("phi3-medium-14b", 2, 4, 512, False, 0.5),
             ("deepseek-coder-33b", 1, 4, 512, True, 0.011),
             ("qwen3-moe-235b-a22b", 1, 4, 512, False, 0.0015))
# the trainer's peak the dry run predicts (tools/zoo_train_peaks.py:
# `build_traced` and `analyse` of repro_torch.launch.dryrun at the path's
# config and B x S on a (1, 1) meta mesh), GiB; tests/test_torch_chip_
# smoke.py holds it to the tool
DRYRUN_PEAK_GIB = {"qwen3-moe-235b-a22b": 70.63}
# the paths whose peak leaves no room for another path on the card: a
# whole run trains them last, once every other phase has ended
ZOO_TRAIN_ALONE = ("qwen3-moe-235b-a22b",)
ZOO_TRAIN_PATH = "train-zoo/"        # --path train-zoo/ARCH: one alone
ZOO_TRAIN_STEPS = 6                  # (a) uninterrupted, and (b)
ZOO_IMAGE_AT, ZOO_FAIL_AT = 3, 5     # (b): a sync image, then a crash
VLM_TRAIN_STEPS = 3                  # no crash path: two runs from one seed
# the grad tolerance: the first step's grads in f32, kernel path against
# the plain path, per leaf max |diff| / max |grad|, worst leaf, at most
# this; a witness whose attention forward is 2% off must read above it.
# Set from the card's readings (H100 80GB HBM3, 700 W), kernel path /
# witness: qwen3-moe 0.000087 / 0.0209 (at 2 layers 0.0023 / 0.211),
# danube 0.125 / 0.510, qwen2-vl 0.0018 / 0.0204, phi3-medium (2 layers)
# 0.315 / 0.863 and deepseek-coder (1 layer) 0.0059 / 0.0196, each
# tolerance near the two's geometric mean (at 2 dense layers the worst
# leaf is a layer-0 attention projection, for phi3-medium as for
# danube).  In bf16
# both read 1.0-1.9 in every arch: a 0.1% change of the attention forward
# moves the bf16 grads of the block leaves by 60-85% (zoo_grad_check)
EXAMPLES = ("quickstart", "serve_with_snapshots", "fault_tolerant_training",
            "elastic_restore")
# a third f32 reading, gating nothing: the plain attention forward times
# (1 + NOISE_REL·ε), ε standard normal; NOISE_REL is the f32 kernels'
# own error against their oracles in phase 1 (1.4e-5-2.3e-5)
NOISE_REL, NOISE_SEED = 2e-5, 1234
# an exact fingerprint's chunk of elements (int64 temporaries of 128 MB)
FP_CHUNK = 1 << 24


@contextlib.contextmanager
def _attention_forward(fn):
    """``ops.attention`` with `fn` in place of the flash kernel's forward
    and the op's own backward (the oracle's, from the saved inputs)."""
    import torch
    from repro_torch.kernels import ops

    class Stand(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            ctx.save_for_backward(q, k, v)
            ctx.causal, ctx.window = causal, window
            return fn(q, k, v, causal=causal, window=window)
        backward = staticmethod(ops._Attention.backward)

    kernel = ops.attention
    ops.attention = lambda q, k, v, *, causal=True, window=0: Stand.apply(
        q, k, v, causal, window)
    try:
        yield
    finally:
        ops.attention = kernel


def _attention_off_by_2pc(q, k, v, causal, window):
    """A broken attention forward for the check to catch: 2% too large
    (the kernel's forward on the card, its plain version on CPU tensors,
    as ``ops.attention`` picks)."""
    from repro_torch.kernels import flash_attention as fa
    o = (fa.flash_attention if q.is_cuda else fa.attention_plain)(
        q, k, v, causal=causal, window=window)
    return (o.float() * 1.02).to(o.dtype)


def _attention_noisy(q, k, v, causal, window):
    """The plain attention forward times (1 + NOISE_REL·ε), ε standard
    normal from a generator seeded anew at each call, so that every layer
    and a remat's recompute see the same ε: relative noise the size of
    the f32 kernels' own error."""
    import torch
    from repro_torch.kernels import ref
    o = ref.attention_ref(q, k, v, causal=causal, window=window)
    gen = torch.Generator(device=o.device).manual_seed(NOISE_SEED)
    eps = torch.randn(o.shape, generator=gen, device=o.device)
    return (o.float() * (1 + NOISE_REL * eps)).to(o.dtype)


def _grad_distance(grads: dict, ref: dict) -> tuple:
    """(max over the leaves of max |diff| / max |ref grad|, that leaf)."""
    worst = (0.0, "")
    for k, w in ref.items():
        diff = (grads[k].float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        if diff:
            worst = max(worst, (diff / scale if scale else float("inf"), k))
    return worst


def zoo_grad_check(cfg, params, batch) -> dict:
    """The first step's grads on the kernel path and on a witness whose
    attention forward is 2% off, each against the plain path on the same
    params and batch, in bf16 compute (the tensor-core flash kernel, as
    trained) and in f32 (the CUDA-core one): {dtype: {name:
    _grad_distance's pair}}; in f32 also the plain forward with relative
    noise of NOISE_REL ("noise", which gates nothing: how far the kernels'
    own error alone moves the grads).  bf16 is ill-conditioned here: a
    0.1% change of the attention forward moves the block leaves' grads by
    60-85% (a CPU run, h2o-danube at d 512), so the check reads f32.  At
    most the reference tree and one other are live at once."""
    import torch
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import loss_and_grads
    dev = params["final_norm"]["scale"].device

    def grads(m, attention=None):
        with (_attention_forward(attention) if attention
              else contextlib.nullcontext()):
            return flatten_with_paths(loss_and_grads(m, params, batch)[1])
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        kernels = LM(cfg, compute_dtype=dtype, use_kernels=True, device=dev)
        ref = grads(LM(cfg, compute_dtype=dtype, device=dev))
        forwards = [("kernels", None), ("2% off", _attention_off_by_2pc)]
        if dtype == torch.float32:
            forwards.append(("noise", _attention_noisy))
        out[str(dtype)[6:]] = {
            name: _grad_distance(grads(kernels, fwd), ref)
            for name, fwd in forwards}
        del ref
    return out


def fingerprint(tree) -> dict:
    """An exact fingerprint of a tree's raw bits, computed where its
    leaves lie: {path: (dtype, shape, s0, s1, s2)}, each leaf's elements
    read as integers x of their own width and summed in int64, wrapping:
    plain (s0), weighted by the odd number 2i + 1 at flat index i (s1),
    and mixed (s2: x xor a multiplicative hash of i, times an odd
    constant, xor-shifted, as ``_mix`` does).  A flip of bit b of one
    element moves s0 by ±2^b and s1 by ±2^b times an odd number, neither
    of them 0 mod 2^64, so one flipped bit always shows; s2 is not linear
    in x, so differences in several elements that cancel in s0 and s1
    do not cancel in it.  Equal trees give equal fingerprints."""
    import torch
    from repro_torch.core.device_plugin import flatten_with_paths
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for path, t in flatten_with_paths(tree).items():
        bits = t.detach().contiguous().reshape(-1).view(
            ints[t.element_size()])
        s = torch.zeros(3, dtype=torch.int64, device=t.device)
        for i in range(0, bits.numel(), FP_CHUNK):
            x = bits[i:i + FP_CHUNK].long()
            idx = torch.arange(i, i + x.numel(), dtype=torch.int64,
                               device=t.device)
            s[0] += x.sum()
            s[1] += (x * (2 * idx + 1)).sum()
            s[2] += _mix(x, idx).sum()
        out[path] = (str(t.dtype), tuple(t.shape), *map(int, s.tolist()))
    return out


# odd 64-bit constants of splitmix64, as signed int64
_MIX_K1, _MIX_K2 = -7046029254386353131, -4658895280553007687


def _mix(x, idx):
    """(x xor idx·K1)·K2, xor-shifted right by 31: int64, wrapping, in
    place on the hash's own buffer (one temporary of x's size)."""
    h = idx.mul_(_MIX_K1).bitwise_xor_(x).mul_(_MIX_K2)
    return h.bitwise_xor_(h >> 31)


def _recording_aux(trainer, into: list):
    """Record each step's ``aux_loss`` from the trainer's step metrics."""
    step = trainer._train_step

    def recorded(batch):
        m = step(batch)
        into.append(float(m["aux_loss"]))
        return m
    trainer._train_step = recorded
    return trainer


def train_zoo_path(arch: str, seed: int, layers=None) -> dict:
    """Phase 10, one arch of ZOO_TRAIN, in a child process, one trainer
    on the card at a time: the first step's grads of the kernel path and
    of a witness against the plain path (``zoo_grad_check``) on the
    params of the trainer's own init at the seed, before any AdamW state
    exists; (a) ZOO_TRAIN_STEPS steps uninterrupted, its final params and
    AdamW state fingerprinted on the card (``fingerprint``), then
    released; (b) a run with a sync image at ZOO_IMAGE_AT that crashes at
    ZOO_FAIL_AT and restores from the image through
    ``run_with_restarts``, bitwise (a)'s losses of the steps after the
    image and (a)'s fingerprints (no crash path: a second run of
    VLM_TRAIN_STEPS from the seed, bitwise equal); a falling loss, a
    finite aux loss (> 0 with MoE, 0 without) at every step, the
    kernels' launches per step.  `layers`: at that depth in place of the
    arch's own (``--path train-zoo/ARCH --layers N``)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_config
    from repro_torch.core.snapshot_io import snapshot_dir
    from repro_torch.data import TokenPipeline
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer, run_with_restarts

    _, own, B, S, crash, tol = next(p for p in ZOO_TRAIN if p[0] == arch)
    layers = own if layers is None else layers
    if layers != own:
        # the tolerance was set from readings at the arch's own depth; at
        # another (tools/cut_ab.py) the kernel path must read below the
        # witness
        tol = None
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    card = card_line()
    dev = torch.device("cuda")
    model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
               device=dev)
    steps = ZOO_TRAIN_STEPS if crash else VLM_TRAIN_STEPS
    tag = f"{cfg.name} ({layers} of {get_config(arch).num_layers} layers)"
    aux = {"a": [], "b": []}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        def trainer(run, ckpt_every=0):
            tcfg = _train_config(B, S, seed, ckpt_every=ckpt_every,
                                 ckpt=CheckpointOptions(mode="sync", keep=1))
            return _recording_aux(Trainer(cfg, tcfg,
                                          os.path.join(workdir, run),
                                          device=dev, model=model),
                                  aux[run])

        # the grad check on the params Trainer.initialize makes at the
        # seed, and the batches its pipeline gives, before any trainer
        torch.cuda.reset_peak_memory_stats()
        params = model.init(seed)
        n_params = sum(t.numel() for t in _leaves(params))
        pipeline = TokenPipeline(cfg, B, S, seed=seed)
        batches = [_device_batch(pipeline.peek(s), dev)
                   for s in range(steps)]
        before = [_score(model, params, b) for b in batches]
        del batches[1:]
        t0 = time.perf_counter()
        err = zoo_grad_check(cfg, params, batches[0])
        grads_s = time.perf_counter() - t0
        check_gb = torch.cuda.max_memory_allocated() / 2**30
        del params
        free()
        torch.cuda.reset_peak_memory_stats()
        counters = _counters()
        _zero_counters()              # this path's launches start here
        t_a = trainer("a")
        t_a.run(steps)                                              # (a)
        losses = list(t_a.metrics_history["loss"])
        step_ms = [t * 1e3 for t in t_a.straggler.times]
        t0 = time.perf_counter()
        print_a = fingerprint({"params": t_a.params, "opt": t_a.opt_state})
        fp_s = time.perf_counter() - t0
        t_a.release()
        del t_a
        free()
        io = {}
        if crash:                                                   # (b)
            made = []

            def make():
                if made:              # the crashed trainer's state goes
                    prev = made[-1]
                    io["image"] = dict(prev.session.last_stats)
                    io["image_bytes"] = _image_bytes(snapshot_dir(
                        prev.session.run_dir, ZOO_IMAGE_AT))
                    prev.release()
                    free()
                t = trainer("b", ZOO_IMAGE_AT if not made else 0)
                restore = t.restore

                def timed_restore(*a, **kw):
                    io["host_gib_before_restore"] = host_available_gib()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = restore(*a, **kw)
                    torch.cuda.synchronize()
                    io["restore_s"] = time.perf_counter() - t0
                    io["host_gib_after_restore"] = host_available_gib()
                    return out
                t.restore = timed_restore
                made.append(t)
                return t
            io["host_gib_before"] = host_available_gib()
            out = run_with_restarts(make, steps, {ZOO_FAIL_AT: "crash"})
            t_b, other = out["trainer"], out["loss_history"]
            executed = steps + ZOO_FAIL_AT + steps - ZOO_IMAGE_AT
            resumed = steps - ZOO_IMAGE_AT
        else:
            t_b = trainer("b")
            t_b.run(steps)
            other = t_b.metrics_history["loss"]
            executed, resumed = 2 * steps, steps
        launches = {name: mod.launches for name, mod in counters.items()}
        variants = _variants()
        print_b = fingerprint({"params": t_b.params, "opt": t_b.opt_state})
        # (b)'s final params, bit for bit (a)'s where the check passes
        after = _score(model, t_b.params, batches[0])
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        same_losses = np.array_equal(np.float64(losses[-resumed:]),
                                     np.float64(other[-resumed:]))
        same_state = print_a == print_b
        t_b.release()
    spread = max(before) - min(before)
    falls = before[0] - after > spread
    aux_ok = all(np.isfinite(a) and (a > 0 if cfg.moe_num_experts
                                     else a == 0)
                 for a in aux["a"] + aux["b"]) and len(aux["a"]) == steps
    qk = 2 if cfg.qk_norm else 0
    per_step = {"flash_attention": 2 * layers, "ssd_scan": 0,
                "rmsnorm": 2 * (2 + qk) * layers + 1}
    want = {k: v * executed for k, v in per_step.items()}
    med = float(np.median(step_ms[1:]))
    tokens = B * S
    flops = train_flops(cfg, n_params, B, S)
    predicted = (f" (the dry run's prediction for the trainer: "
                 f"{DRYRUN_PEAK_GIB[arch]:.2f} GiB)"
                 if arch in DRYRUN_PEAK_GIB and layers == own else "")
    log(f"[train-zoo] {tag}: {n_params} params (f32 masters, bf16 "
        f"compute, remat, kernels), batch {B} x {S}; losses (a) "
        f"{[round(x, 4) for x in losses]}; aux_loss (a) "
        f"{[round(x, 4) for x in aux['a']]}; peak device memory "
        f"{peak_gb:.2f} GiB with one trainer on the card at a time, the "
        f"grad check's {check_gb:.2f} GiB{predicted}; {card}")
    for dtype, e in err.items():
        k, w = e["kernels"], e["2% off"]
        noise = (f"; plain forward with relative noise {NOISE_REL:g} "
                 f"{e['noise'][0]:.4g} ({e['noise'][1]}), gating nothing"
                 if "noise" in e else "")
        log(f"[train-zoo] {tag}: first step's grads in {dtype} against "
            f"the plain {dtype} path, worst leaf by max |diff| / max "
            f"|grad|: kernels {k[0]:.4g} ({k[1]}); witness with the "
            f"attention forward 2% off {w[0]:.4g} ({w[1]}){noise}; limit "
            f"{tol if tol is not None else 'the witness'} "
            f"(float32); {grads_s:.1f} s; {card}")
    log(f"[train-zoo] {tag}: step {med:.2f} ms (median but the first of "
        f"(a), host clock, each step ending in the loss's read-back; all "
        f"{[round(x, 1) for x in step_ms]}), {tokens / med * 1e3:.0f} "
        f"tokens/s, {flops / 1e12:.3f} TFLOP/step, MFU "
        f"{flops / (med * 1e-3) / BF16_PEAK:.2%} of 989 TFLOP/s bf16; "
        f"{card}")
    if crash:
        st = io["image"]
        log(f"[train-zoo] {tag}: (b) sync image at step {ZOO_IMAGE_AT}: "
            f"{io['image_bytes']} bytes, freeze "
            f"{st['lock_s'] + st['frozen_s']:.3f} s, checkpoint() "
            f"{st.get('total_s', st.get('locked_total_s')):.2f} s (write "
            f"{st['write_s']:.2f} s, hash {st.get('hash_s') or 0:.2f} s); "
            f"crash at step {ZOO_FAIL_AT}, cold restore "
            f"{io['restore_s']:.2f} s; host "
            f"MemAvailable {io['host_gib_before']:.1f} GiB before (b), "
            f"{io['host_gib_before_restore']:.1f} before the restore, "
            f"{io['host_gib_after_restore']:.1f} after; {card}")
    second = "(b) after its restore" if crash else "the second run"
    log(f"[train-zoo] {tag}: {second}, with (a) released before it: "
        f"losses of the last {resumed} steps bitwise (a)'s: {same_losses}; "
        f"final params and AdamW state fingerprints ({len(print_a)} "
        f"leaves, on the card, {fp_s:.2f} s) equal: {same_state}; aux_loss "
        f"finite{' and > 0' if cfg.moe_num_experts else ''} at every "
        f"step: {aux_ok}; step 0's batch scored {before[0]:.5f} before, "
        f"{after:.5f} after (b): drop {before[0] - after:.5f} against the "
        f"{steps} batches' spread {spread:.5f}: {falls}; launches over "
        f"{executed} executed steps {launches} (want {want}); by variant "
        f"{variants}; {card}")
    kernel32, witness32 = (err["float32"][k][0] for k in ("kernels",
                                                          "2% off"))
    bad = [name for name, ok in (
        ("losses", same_losses), ("params and AdamW state", same_state),
        ("aux loss", aux_ok), ("loss falls", falls),
        ("grads", kernel32 <= (witness32 if tol is None else tol)),
        ("witness", witness32 > (kernel32 if tol is None else tol)),
        ("launches", launches == want),
        ("flash on tc only", variants["flash_attention"]["fma"] == 0))
        if not ok]
    if bad:
        raise SystemExit(f"{tag} training failed: {bad}")
    return {"launches": launches, "variants": variants}


def run_examples() -> dict:
    """Phase 10's last part: each of ``examples/torch/``'s
    ``main(device="cuda", run_dir)``, in this process (each asserts what
    its JAX counterpart asserts); what each printed goes to the log as
    ``[examples]`` lines.  The examples run their smoke configs on the
    plain path, as the JAX package's do: no kernel launches."""
    import importlib.util
    import io
    _zero_counters()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        for name in EXAMPLES:
            spec = importlib.util.spec_from_file_location(
                f"example_{name}", HERE / "examples" / "torch" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                mod.main(device="cuda", run_dir=os.path.join(workdir, name))
            wall = time.perf_counter() - t0
            for line in printed.getvalue().splitlines():
                log(f"[examples] {name}: {line}")
            log(f"[examples] {name}: {wall:.2f} s; {card_line()}")
    return {"launches": {n: m.launches for n, m in _counters().items()},
            "variants": _variants()}


def train_zoo_archs(seed: int, archs) -> dict:
    """Each arch of `archs` (of ZOO_TRAIN) in a child process of its own,
    one after the other (its pinned host buffers leave with it); {path:
    (launches, variants)}."""
    out = {}
    for arch, layers, *_ in ZOO_TRAIN:
        if arch not in archs:
            continue
        t0 = time.perf_counter()
        res = run_child(f"phase 10 {arch}", train_zoo_path, arch, seed)
        out[f"{arch} train ({layers} layers)"] = (res["launches"],
                                                  res["variants"])
        log(f"[train-zoo] {arch}: {time.perf_counter() - t0:.1f} s; "
            f"{card_line()}")
    return out


def phase_train_zoo(seed: int, archs=tuple(p[0] for p in ZOO_TRAIN)
                    ) -> dict:
    """Phase 10: the archs `archs` of ZOO_TRAIN, then the examples, each
    in a child process of its own; {path: (launches, variants)}."""
    t_phase = time.perf_counter()
    out = train_zoo_archs(seed, archs)
    t0 = time.perf_counter()
    res = run_child("phase 10 examples", run_examples)
    out["examples (smoke configs)"] = (res["launches"], res["variants"])
    log(f"[train-zoo] examples: {time.perf_counter() - t0:.1f} s; phase 10 "
        f"wall {time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return out


# ----------------------------------------------------------------- phase 11
DIST_ARCH = "qwen1.5-0.5b"
DIST_PATH = "dist"         # --path: phase 11 alone (tools/cut_ab.py)
# full width, cut to 1 of 24 layers for the run's budget: in turns
# (tools/cut_ab.py --path dist --layers 1, H100) 24 -> 1 layer saved 81.4
# s; each image keeps the 155.6 M-param embedding (2.02 of 5.57 GB)
DIST_LAYERS = 1
DIST_STEPS, DIST_EVERY, DIST_KILL_AT = 12, 4, 8
DIST_SEQ = 512
DIST_TIMEOUT_S = 60        # --dist-timeout: each collective, the barrier
DIST_TOKENS, DIST_SNAPSHOT_AT = 16, 8
DIST_SMOKE = ["--smoke", "--steps", "4", "--ckpt-every", "4", "--ckpt-mode",
              "sync", "--keep", "0", "--batch-size", "4", "--seq-len", "16",
              "--dist-timeout", str(DIST_TIMEOUT_S)]


def dist_batch(n: int) -> int:
    """Phase 11's global batch rows: 4 when the ranks divide it, else one
    row per rank."""
    return 4 if 4 % n == 0 else n


def _rank_launches(res: dict) -> dict:
    """A launcher run's kernel launches over all its ranks (its JSON's
    ``per_rank``), else this process's counters (rank 0 alone)."""
    per_rank = (res.get("json") or {}).get("per_rank")
    if not per_rank:
        return res["launches"]
    return {k: sum(r["launches"][k] for r in per_rank)
            for k in res["launches"]}


def dist_rank(argv, group) -> int:
    """A rank of phase 11's launcher runs: ``rank_main`` of the ``train``
    or ``serve`` launcher (``argv[0]``) on DIST_ARCH at its full width cut
    to ``argv[1]`` layers, with the launcher's arguments ``argv[3:]``.
    ``argv[2]`` ``"R:S"`` (or ``"-"``): rank R is SIGKILLed between its
    pack of step S's image and its PREPARED marker, a fault on the chaos
    hook plane."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dist, serve, train
    kind, layers, kill, *rest = argv
    cfg = dataclasses.replace(get_config(DIST_ARCH), num_layers=int(layers))
    if kill != "-":
        rank, step = map(int, kill.split(":"))
        if group.rank == rank:
            from repro_torch.chaos import hooks
            hooks.install(dist.KillBeforePrepare(step))
    launcher = {"train": train, "serve": serve}[kind]
    return launcher.rank_main(rest, group, cfg=cfg)


def dist_modes_rank(argv, group) -> int:
    """A rank of phase 11 (e): the train launcher's ``rank_main`` on
    DIST_ARCH at ``argv[0]`` layers with the engine's modes as
    ``CheckpointOptions`` (the launcher has no flag for them): soft-freeze
    captures of incremental images, replicated in copy mode to the peer
    directory ``argv[1]``, restored lazily (``--restore``); each image's
    numbers, of every rank, go to the JSON file ``argv[2]``; the
    launcher's arguments ``argv[3:]``."""
    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.core.engine import SnapshotEngine
    layers, peer, numbers, *rest = argv
    cfg = dataclasses.replace(get_config(DIST_ARCH), num_layers=int(layers))
    ckpt = CheckpointOptions(mode="sync", keep=0, incremental=True,
                             capture="concurrent", replicate_to=peer,
                             restore_mode="lazy")
    # each image's numbers once it is committed and pushed (the
    # launcher's JSON has the last image's only)
    dumps, after = [], SnapshotEngine._after_commit

    def after_commit(engine, ctx, path):
        out = after(engine, ctx, path)
        dumps.append({"step": ctx.step, **{k: ctx.stats.get(k) for k in (
            "replicate_s", "replica_bytes_copied", "barrier_wait_s",
            "written_bytes", "reused_bytes")}})
        return out
    SnapshotEngine._after_commit = after_commit
    rc = train.rank_main(rest, group, cfg=cfg, ckpt=ckpt)
    dumps = group.gather_objects(dumps)
    if group.rank == 0:
        with open(numbers, "w") as f:
            json.dump(dumps, f)
    return rc


def _modes_run(what: str, n: int, layers: int, peer: str, numbers: str,
               argv: list) -> dict:
    """`dist_modes_rank` in `n` card ranks (a child process, rank 0)."""
    from repro_torch.launch import dist
    run = argv[argv.index("--run-dir") + 1]
    t0 = time.perf_counter()
    res = run_child(what, _captured, dist.launch,
                    "chip_smoke:dist_modes_rank",
                    [str(layers), peer, numbers, *argv], n, "cuda", run,
                    DIST_TIMEOUT_S)
    if res["rc"] != 0:
        raise SystemExit(f"phase 11 {what}: exit {res['rc']}\n"
                         f"{res['out'][-2000:]}\n{res['err']}")
    res["launches"] = _rank_launches(res)
    res["wall_s"] = time.perf_counter() - t0
    return res


def _image_steps(run: str) -> dict:
    """{image step: (the trainer's step at its validate pause, its
    loss history)} of every image in `run`."""
    from repro_torch.core.snapshot_io import SnapshotStore
    store, out = SnapshotStore(run), {}
    for step in store.list_steps():
        reader = store.reader(step, verify=False)
        try:
            st = reader.host_state()["trainer"]
        finally:
            reader.close()
        out[step] = (st["step"], st["loss_hist"])
    return out


def dist_modes(workdir: str, n: int, layers: int, run_a: str,
               card: str) -> list:
    """Phase 11 (e): (e1) (a)'s job under the engine's modes, (e2) a lazy
    restore of it from the replica alone (see the module docstring).
    Returns the two runs (their launches)."""
    from repro_torch.core.snapshot_io import MANIFEST, SnapshotStore
    want = _image_steps(run_a)[DIST_STEPS][1]
    crc_a = _entry_crcs(run_a, DIST_STEPS)
    run_e, peer = (os.path.join(workdir, x) for x in ("e", "peer"))
    argv = _train_argv(n, run_e, "--restore")
    e1 = _modes_run("(e1) concurrent, incremental, replicated", n, layers,
                    peer, os.path.join(workdir, "e1.json"),
                    _train_argv(n, run_e))
    images = _image_steps(run_e)
    store = SnapshotStore(run_e)
    # a step off the grid is a just-in-time image (the straggler monitor
    # fires while a speculation slows the steps)
    if not {DIST_EVERY * k for k in (1, 2, 3)} <= set(images) or \
            images[DIST_STEPS][1] != want:
        raise SystemExit(f"phase 11 (e1): images {images} against (a)'s "
                         f"losses {want}")
    for step in sorted(images):
        man = store.manifest(step)
        cs = man["capture_stats"]
        log(f"[dist] (e1) image {step} (validate pause at step "
            f"{images[step][0]}, parent {man['parent']}): pin_pause_s "
            f"{cs['pin_pause_s']:.4f}, validate_pause_s "
            f"{cs['validate_pause_s']:.3f}, speculate_s "
            f"{cs['speculate_s']:.3f}, recaptured_bytes "
            f"{cs['recaptured_bytes']:.0f}, written_bytes "
            f"{man['written_bytes']} / reused_bytes {man['reused_bytes']}"
            f"; {card}")
    with open(os.path.join(workdir, "e1.json")) as f:
        numbers = json.load(f)
    for rank, dumps in enumerate(numbers):
        for d in dumps:
            log(f"[dist] (e1) rank {rank}, image {d['step']}: "
                f"replicate_s {d['replicate_s']:.3f} (copy mode, "
                f"{d['replica_bytes_copied']} bytes copied), barrier_wait_s "
                f"{d['barrier_wait_s']:.4f}, written_bytes "
                f"{d['written_bytes']:.0f} / reused_bytes "
                f"{d['reused_bytes']:.0f}; {card}")
    for r in e1["json"]["per_rank"]:
        log(f"[dist] (e1) rank {r['rank']}: step {r['step_ms']:.2f} ms "
            f"(median of steps 2-{DIST_STEPS}); {card}")
    # the replica as it stood when the newest image holding a step below
    # 12 was its newest: (e2) then has steps to run
    keep = max((s for s, (at, _) in images.items() if at < DIST_STEPS),
               default=None)
    if keep is None:
        raise SystemExit(f"phase 11 (e1): every image's validate pause came "
                         f"at step {DIST_STEPS}: {images}")
    for step in SnapshotStore(peer).list_steps():
        if step > keep:
            shutil.rmtree(os.path.join(peer, "snapshots", f"step_{step:08d}"))
    shutil.rmtree(run_e)
    e2 = _modes_run("(e2) lazy restore from the replica", n, layers, peer,
                    os.path.join(workdir, "e2.json"), argv)
    got = _image_steps(run_e)
    crc_e = _entry_crcs(run_e, DIST_STEPS)
    rst = e2["json"]["per_rank"][0]["restore"]
    first = images[keep][0]
    if not rst or not rst["restored_from_replica"] or \
            rst["restore_mode"] != "lazy" or \
            got[DIST_STEPS][1] != want or crc_e != crc_a:
        diff = sorted(k for k in crc_a if crc_a[k] != crc_e.get(k))
        raise SystemExit(f"phase 11 (e2): restore {rst}, losses "
                         f"{got[DIST_STEPS][1]} against {want}, entries "
                         f"differing {diff[:5]}")
    for r in e2["json"]["per_rank"]:
        rs = r["restore"]
        log(f"[dist] (e2) rank {r['rank']}: image {keep} pulled from the "
            f"replica (validate pause at step {first}), lazy: "
            f"restore_critical_s {rs['restore_critical_s']:.3f} "
            f"(critical_bytes {rs['critical_bytes']:.0f}), "
            f"restore_background_s {rs['restore_background_s']:.3f} "
            f"(background_bytes {rs['background_bytes']:.0f}); ran steps "
            f"{first + 1}-{DIST_STEPS}: losses {first + 1}-{DIST_STEPS} "
            f"bitwise (a)'s, step-{DIST_STEPS} entries CRC for CRC ("
            f"{len(crc_a)}); {card}")
    log(f"[dist] (e) walls: (e1) {e1['wall_s']:.1f} s, (e2) "
        f"{e2['wall_s']:.1f} s; {card}")
    return [e1, e2]


def _dist_launcher(kind: str, layers: int, kill: str, n: int,
                   argv: list) -> dict:
    """`dist_rank` in `n` card ranks through ``launch.dist.launch``, this
    (child) process rank 0 (see `_captured`)."""
    from repro_torch.launch import dist
    run = argv[argv.index("--run-dir") + 1]
    return _captured(dist.launch, "chip_smoke:dist_rank",
                     [kind, str(layers), kill, *argv], n, "cuda", run,
                     DIST_TIMEOUT_S)


def _dist_run(what: str, kind: str, n: int, layers: int, argv: list,
              kill: str = "-", want_rc=0) -> dict:
    """A launcher run in a child process (rank 0 there, the other ranks
    spawned by ``launch.dist``); `want_rc` None: the child may be killed
    (the last rank of one is rank 0)."""
    t0 = time.perf_counter()
    res = run_child(what, _dist_launcher, kind, layers, kill, n, argv,
                    killed_ok=want_rc is None)
    wall = time.perf_counter() - t0
    if res is None:
        return {"killed": True, "wall_s": wall, "json": None,
                "launches": {k: 0 for k in _counters()},
                "variants": _variants()}
    if want_rc is not None and res["rc"] != want_rc:
        raise SystemExit(f"phase 11 {what}: exit {res['rc']}, not "
                         f"{want_rc}\n{res['out'][-2000:]}\n{res['err']}")
    res["launches"] = _rank_launches(res)
    res["wall_s"] = wall
    return res


def _train_argv(n: int, run: str, *extra) -> list:
    return ["--arch", DIST_ARCH, "--device", "cuda", "--nproc", str(n),
            "--steps", str(DIST_STEPS),
            "--ckpt-every", str(DIST_EVERY), "--ckpt-mode", "sync",
            "--keep", "0", "--batch-size", str(dist_batch(n)), "--seq-len",
            str(DIST_SEQ), "--dist-timeout", str(DIST_TIMEOUT_S),
            "--run-dir", run, *extra]


def _entry_crcs(run: str, step: int) -> dict:
    from repro_torch.core.snapshot_io import SnapshotStore
    crcs = SnapshotStore(run).manifest(step)["entry_crcs"]
    return {k: v for k, v in crcs.items() if k.startswith("train_state::")}


def dist_check_rank(argv, group) -> int:
    """One rank of a cross-device check: ``elastic_restore`` of the newest
    image in ``argv[0]`` onto this group's process mesh (``argv[1]``:
    "smoke", or the layers of DIST_ARCH at full width), every leaf's block
    held bitwise against the image's whole leaf (read whole, on the
    host) cut at this rank's index."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.core.snapshot_io import SnapshotStore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.encdec import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.sharding import state_shardings
    from repro_torch.serialization.pack import dtype_from_str
    from repro_torch.sharding.policy import index_to_json, rank_index
    run, layers = argv
    cfg = (get_smoke_config(DIST_ARCH) if layers == "smoke" else
           dataclasses.replace(get_config(DIST_ARCH), num_layers=int(layers)))
    model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                        device=group.device)
    mesh = make_host_mesh(data=group.world, model=1, device=group.device,
                          group=group)
    got = elastic_restore(run, mesh, model, AdamW(lr=constant(0.0)))
    flat = flatten_with_paths({"params": got["params"], "opt": got["opt"]})
    sh = flatten_with_paths(state_shardings(model, mesh))
    reader = SnapshotStore(run).reader()
    bad = []
    try:
        for k, t in flat.items():
            meta = reader.meta["train_state"][k]
            shape = tuple(meta["shape"])
            idx = rank_index(sh[k], shape)
            # the saved blocks that meet this rank's, laid out whole
            entry = reader.load_entry("train_state", k,
                                      region=index_to_json(idx, shape))
            whole = np.zeros(shape, dtype_from_str(meta["dtype"]))
            for blk in entry["shards"]:
                if blk["data"] is not None:
                    at = tuple(slice(a, b) for a, b in blk["index"])
                    whole[at] = np.asarray(blk["data"]).reshape(
                        whole[at].shape)
            want = np.ascontiguousarray(whole[idx])
            have = t.detach().cpu().contiguous().numpy()
            if have.tobytes() != want.tobytes():
                bad.append(k)
    finally:
        reader.close()
    if bad:
        raise SystemExit(f"rank {group.rank}: {len(bad)} leaves differ from "
                         f"the image, e.g. {bad[:3]}")
    return 0


def wait_image(run: str, proc=None, timeout_s: float = 300.0) -> None:
    """Wait for a committed image in `run` (while `proc` lives)."""
    from repro_torch.core.snapshot_io import SnapshotStore
    t0 = time.monotonic()
    while not SnapshotStore(run).list_steps():
        if proc is not None and proc.exitcode is not None:
            raise SystemExit(f"phase 11: no image in {run}; its writer "
                             f"exited {proc.exitcode}")
        if time.monotonic() - t0 > timeout_s:
            raise SystemExit(f"phase 11: no image in {run} after "
                             f"{timeout_s:.0f} s")
        time.sleep(0.05)


def dist_train_then_check(argv, group) -> int:
    """The train launcher's rank on DIST_SMOKE into ``argv[2]``, then, in
    the same group, `dist_check_rank` of ``argv[:2]`` once that image is
    committed."""
    import io
    from repro_torch.launch import train
    with contextlib.redirect_stdout(io.StringIO()):      # its JSON
        rc = train.rank_main(DIST_SMOKE + ["--device", group.device.type,
                                           "--run-dir", argv[2]], group)
    wait_image(argv[0])
    return rc or dist_check_rank(argv[:2], group)


def dist_check(run: str, layers: str, ranks: int, device: str,
               train_first: str = None) -> dict:
    """`dist_check_rank` over `ranks` ranks on `device` (this process is
    rank 0; with `train_first`, `dist_train_then_check` into that run
    directory); the time it took."""
    from repro_torch.launch import dist
    t0 = time.perf_counter()
    if device == "cpu":
        # CPU ranks beside the card's work: two threads each (this child
        # and the rank it spawns)
        os.environ["OMP_NUM_THREADS"] = "2"
        import torch
        torch.set_num_threads(2)
    if train_first:
        rc = dist.launch("chip_smoke:dist_train_then_check",
                         [run, layers, train_first], ranks, device,
                         train_first, DIST_TIMEOUT_S)
    else:
        rc = dist.launch("chip_smoke:dist_check_rank", [run, layers], ranks,
                         device, run, DIST_TIMEOUT_S)
    if rc:
        raise SystemExit(f"phase 11 (c): {ranks} {device} rank(s) did not "
                         f"restore {run} bit-equal")
    return {"wall_s": time.perf_counter() - t0}


def phase_dist(seed: int, card: str, layers: int = DIST_LAYERS) -> dict:
    """Phase 11: the launchers over every card of the host, one process per
    card (``launch.dist``; N = ``torch.cuda.device_count()``), at
    qwen1.5-0.5b's full width and `layers` layers.  (a) 12 steps with sync
    images every 4; (b) the same with the last rank killed between its
    step-8 pack and its PREPARED marker: no step-8 manifest, and
    ``--restore`` from step 4 reaches (a)'s final loss and (a)'s step-12
    entries (params, AdamW state) CRC for CRC; (c) images across devices
    and world sizes restored bit-equal: (a)'s step-12 image on 2 CPU
    ranks (beside (b)), a smoke image of those 2 CPU ranks on the card's
    N ranks, and with N >= 2 (a)'s image on one rank; (d) the serve launcher
    snapshots and resumes token-exact.  The train launcher's JSON gives
    each rank's step time, pack bytes and commit barrier wait (e)."""
    import torch
    n = torch.cuda.device_count()
    t_phase = time.perf_counter()
    B = dist_batch(n)
    log(f"[dist] ranks {n} (one per card), {DIST_ARCH} at full width, "
        f"{layers} of 24 layers, global batch {B} x {DIST_SEQ}; {card}")
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        run_a, run_b = (os.path.join(workdir, x) for x in ("a", "b"))
        a = _dist_run("(a) train", "train", n, layers, _train_argv(n, run_a))
        _check_kernels("(a) train", a["launches"], a["variants"])
        ja = a["json"]
        # the period's images, and one more wherever the straggler
        # monitor flagged a slow step (a just-in-time image)
        want = sorted({4, 8, 12} | set(ja["jit_snapshots"]))
        if ja["ranks"] != n or ja["snapshots"] != want:
            raise SystemExit(f"phase 11 (a): ranks {ja['ranks']}, images "
                             f"{ja['snapshots']}, want {want}")
        # the launchers lay the ranks over data, as the reference's lay
        # its devices; the model axis (expert parallelism) is the API's,
        # held at 4 gloo ranks on (2, 2) by tests/test_torch_dist_ep.py
        log(f"[dist] (a) process mesh {ja['mesh']} (data x model) over "
            f"{n} rank(s); a model axis above 1 needs several cards: CPU "
            f"tests only; {card}")
        if ja["mesh"] != {"data": n, "model": 1}:
            raise SystemExit(f"phase 11 (a): mesh {ja['mesh']}, want "
                             f"data {n} x model 1")
        if ja["jit_snapshots"]:
            log(f"[dist] (a) just-in-time images at steps "
                f"{ja['jit_snapshots']} (the straggler monitor); {card}")
        for r in ja["per_rank"]:
            log(f"[dist] (a) rank {r['rank']}: step {r['step_ms']:.2f} ms "
                f"(median of steps 2-{DIST_STEPS}; the first "
                f"{r['first_step_ms']:.1f} ms; the whole-gather step on "
                f"an H100 at 700 W: 37.61-41.79 ms), pack "
                f"{int(r['pack_bytes'])} bytes (step 12), commit barrier "
                f"wait {r['barrier_wait_s'] * 1e3:.2f} ms, device peak "
                f"{r['peak_bytes']} bytes (max_memory_allocated; the "
                f"whole-gather step's: 8651915264; its blocks of params "
                f"and moments {r['block_bytes']} bytes), gathered peak "
                f"{r['gathered_peak_bytes']} bytes and "
                f"{r['gathered_bytes']} bytes gathered a step (the "
                f"model's per-layer gathers; 0 at one rank); {card}")
            if n == 1 and (r["gathered_peak_bytes"] or r["gathered_bytes"]):
                raise SystemExit("phase 11 (a): one rank gathered params "
                                 "that it holds whole")
        log(f"[dist] (a) {DIST_STEPS} steps + 3 sync images: wall "
            f"{a['wall_s']:.1f} s, final loss {ja['final_loss']!r}")
        runs.append(a)

        # (c), first half, beside (b) and on the host's cores: 2 CPU ranks
        # write a smoke image, then restore (a)'s step-12 image
        cpu_img = os.path.join(workdir, "c")
        t_cpu = time.perf_counter()
        cpu = start_child("(c) 2 CPU ranks", dist_check, run_a,
                          str(layers), 2, "cpu", cpu_img)

        # (b) resumes (a)'s step-4 image (hard links: the bytes (a)
        # wrote, bit for bit, at no write cost)
        victim = n - 1
        step4 = os.path.join("snapshots", f"step_{DIST_EVERY:08d}")
        shutil.copytree(os.path.join(run_a, step4),
                        os.path.join(run_b, step4), copy_function=os.link)
        b = _dist_run("(b) train, last rank killed", "train", n, layers,
                      _train_argv(n, run_b, "--restore"),
                      kill=f"{victim}:{DIST_KILL_AT}",
                      want_rc=None if n == 1 else 1)
        from repro_torch.core.snapshot_io import SnapshotStore
        torn = sorted(os.listdir(os.path.join(
            run_b, "snapshots", f"step_{DIST_KILL_AT:08d}")))
        if SnapshotStore(run_b).list_steps() != [4] or \
                f"host{victim:04d}.pack.0" not in torn:
            raise SystemExit(f"phase 11 (b): images "
                             f"{SnapshotStore(run_b).list_steps()} after "
                             f"the kill, step {DIST_KILL_AT}: {torn}")
        if n > 1 and b["wall_s"] > DIST_STEPS * 30 + DIST_TIMEOUT_S:
            raise SystemExit(f"phase 11 (b): rank 0 took {b['wall_s']:.1f}"
                             f" s to exit")
        back = _dist_run("(b) train --restore", "train", n, layers,
                         _train_argv(n, run_b, "--restore"))
        jb = back["json"]
        if f"at step 4" not in back["out"] or \
                jb["final_loss"] != ja["final_loss"]:
            raise SystemExit(f"phase 11 (b): final loss {jb['final_loss']!r}"
                             f" after the restore, {ja['final_loss']!r} "
                             f"uninterrupted")
        crc_a, crc_b = _entry_crcs(run_a, 12), _entry_crcs(run_b, 12)
        if crc_a != crc_b:
            diff = sorted(k for k in crc_a if crc_a[k] != crc_b.get(k))
            raise SystemExit(f"phase 11 (b): step-12 entries differ: "
                             f"{diff[:5]}")
        log(f"[dist] (b) from (a)'s step-4 image: rank {victim} "
            f"SIGKILLed after its step-"
            f"{DIST_KILL_AT} pack, before PREPARED ("
            f"{'the one rank: the launcher died with it' if n == 1 else 'rank 0 exited 1 on the barrier deadline'}"
            f", {b['wall_s']:.1f} s): no step-{DIST_KILL_AT} manifest "
            f"({torn}); --restore from step 4 in "
            f"{jb['restore_s']:.3f} s reached final loss "
            f"{jb['final_loss']!r} bitwise and (a)'s {len(crc_a)} step-12 "
            f"entries CRC for CRC ({back['wall_s']:.1f} s); {card}")
        runs += [b, back]

        t0 = time.perf_counter()
        wait_image(cpu_img, cpu[1])
        onto_card = run_child("(c) CPU image -> card", dist_check, cpu_img,
                              "smoke", n, "cuda")
        cpu = join_child(cpu)
        line = (f"[dist] (c) bit-equal: (a)'s step-12 image ({n} card "
                f"rank(s)) on 2 CPU ranks, which first wrote a smoke image ("
                f"{cpu['wall_s']:.1f} s for both, beside (b): "
                f"{time.perf_counter() - t_cpu:.1f} s from their start), "
                f"that image on {n} card rank(s) ({onto_card['wall_s']:.1f}"
                f" s)")
        if n >= 2:
            one = run_child("(c) (a) image -> 1 rank", dist_check, run_a,
                            str(layers), 1, "cuda")
            line += (f", (a)'s step-12 image on 1 card rank "
                     f"({one['wall_s']:.1f} s)")
        log(f"{line}; (c) after (b) {time.perf_counter() - t0:.1f} s; "
            f"{card}")

        run_s = os.path.join(workdir, "s")
        serve = ["--arch", DIST_ARCH, "--device", "cuda", "--nproc", str(n),
                 "--batch", str(B), "--prompt-len",
                 str(DIST_SEQ), "--max-seq", str(2 * DIST_SEQ), "--tokens",
                 str(DIST_TOKENS), "--dist-timeout", str(DIST_TIMEOUT_S),
                 "--run-dir", run_s]
        snap = _dist_run("(d) serve --snapshot-at", "serve", n, layers,
                         serve + ["--snapshot-at", str(DIST_SNAPSHOT_AT)])
        srv_back = _dist_run("(d) serve --restore", "serve", n, layers,
                             serve + ["--restore"])
        if srv_back["json"]["tokens_sha256"] != snap["json"]["tokens_sha256"]:
            raise SystemExit("phase 11 (d): the restored tokens differ")
        ts = snap["json"]["timings"]
        log(f"[dist] (d) serve B {B} x {DIST_SEQ} over {n} rank(s): "
            f"{srv_back['json']['generated']} tokens token-exact after "
            f"--snapshot-at {DIST_SNAPSHOT_AT} + --restore; decode "
            f"{ts['decode_s_per_token'] * 1e3:.2f} ms/token, checkpoint "
            f"{ts['checkpoint_s']:.3f} s, restore "
            f"{srv_back['json']['timings']['restore_s']:.3f} s; packs "
            f"{[int(r['pack_bytes']) for r in snap['json']['per_rank']]} "
            f"bytes, barrier wait "
            f"{[round(r['barrier_wait_s'] * 1e3, 2) for r in snap['json']['per_rank']]}"
            f" ms, gathered peak "
            f"{[r['gathered_peak_bytes'] for r in snap['json']['per_rank']]}"
            f" bytes; {card}")
        runs += [snap, srv_back]
        runs += dist_modes(workdir, n, layers, run_a, card)
    if n == 1:
        log("[dist] one card: phase 11 ran 1 rank through the whole "
            "multi-rank path (process group, per-rank packs, two-phase "
            "commit, restores across devices, the engine's modes) on a "
            "(1, 1) process mesh; more than one rank, and the model axis "
            "(expert-parallel MoE on (2, 2)), were held only by the CPU "
            "tests (tests/test_torch_dist*.py, gloo)")
    launches, variants = _merge_launches(runs)
    log(f"[dist] phase 11 wall {time.perf_counter() - t_phase:.1f} s, "
        f"launches flash / RMSNorm {launches['flash_attention']} / "
        f"{launches['rmsnorm']}; {card}")
    return {f"{DIST_ARCH} dist (phase 11)": (launches, variants)}


# ------------------------------------------------------------------- main
KERNEL_ROWS = (
    ("flash_attention", "cuda", "src/repro_torch/csrc/flash_attention_tc.cu",
     "src/repro/kernels/flash_attention.py:29"),
    ("rmsnorm", "triton", "src/repro_torch/kernels/rmsnorm.py",
     "src/repro/kernels/rmsnorm.py:19"),
    ("ssd_scan", "cuda", "src/repro_torch/csrc/ssd_scan_tc.cu",
     "src/repro/kernels/ssd_scan.py:31"),
)
# each row's numbers: the bf16 case at its slice shape
ROW_CASE = {"flash_attention": "flash_attention/tc",
            "rmsnorm": f"rmsnorm/{NORM_SLICE[1]}", "ssd_scan": "ssd_scan/tc"}
# the libraries whose SASS must hold tensor-core instructions
TC_SOURCES = ("flash_attention_tc", "ssd_scan_tc")
VARIANT_SOURCES = {
    "flash_attention": {"tc": "src/repro_torch/csrc/flash_attention_tc.cu",
                        "fma": "src/repro_torch/csrc/flash_attention.cu"},
    "ssd_scan": {"tc": "src/repro_torch/csrc/ssd_scan_tc.cu",
                 "fma": "src/repro_torch/csrc/ssd_scan.cu"},
}
TIMES = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
         "bound_by")


def kernel_rows(rows: dict, by_path: dict) -> list:
    """The `kernels` line: one row per kernel (its slice case, its launches
    on the serving paths); flash attention's and the SSD scan's variants
    (tc at the bf16 slice, fma at the f32 slice) and long-prompt timings;
    RMSNorm at d = 5120 and its two designs; each kernel at the zoo
    paths' shapes, at those of the encoder-decoder and VLM paths, at
    the zoo's training shapes and at the dense split's per-rank shapes."""
    out = []
    for name, route, source, replaces in KERNEL_ROWS:
        row = dict(name=name, route=route, source=source, replaces=replaces,
                   **{k: rows[ROW_CASE[name]][k] for k in TIMES})
        row["launches"] = sum(p[name] for p, _ in by_path.values())
        row["launches_by_path"] = {a: p[name] for a, (p, _) in
                                   by_path.items()}
        out.append(row)
    fa_row, rn_row, ssd_row = out
    for row in (fa_row, ssd_row):
        name = row["name"]
        row["variants"] = [dict(
            variant=kind, source=VARIANT_SOURCES[name][kind],
            launches=sum(v[name][kind] for _, v in by_path.values()),
            served=[s for _, v in by_path.values()
                    for s in v[name]["served"][kind]],
            timed_dtype="bfloat16" if kind == "tc" else "float32",
            **{k: rows[f"{name}/{kind}"][k] for k in TIMES})
            for kind in ("tc", "fma")]
    long = rows["flash_attention/long"]
    fa_row["long"] = dict(case=list(ATTN_LONG), tflops=long["tflops"],
                          **{k: long[k] for k in TIMES if k != "plain_ms"})
    fa_row["hgmma"] = rows["hgmma"]["flash_attention_tc"]
    long = rows["ssd_scan/long"]
    ssd_row["long"] = dict(case=list(SSD_LONG),
                           **{k: long[k] for k in TIMES})
    ssd_row["bound_f32_peak_ms"] = rows["ssd_scan/tc"]["bound_f32_peak_ms"]
    ssd_row["in_turns_bf16_ms"] = rows["ssd_scan/turns"]
    ssd_row["passes_ms"] = rows["ssd_scan/passes"]
    ssd_row["hgmma"] = rows["hgmma"]["ssd_scan_tc"]
    rn_row["wide"] = dict(shape=list(NORM_DESIGN_SHAPE), **{
        k: rows[f"rmsnorm/{NORM_DESIGN_SHAPE[1]}"][k] for k in TIMES})
    rn_row["designs_ms"] = rows["rmsnorm/designs"]
    for row in out:
        for group in ("zoo", "mm", "train"):
            row[group] = rows[group][row["name"]]
        # the per-rank shapes of the dense split (phase 1 only)
        row["tp"] = rows["tp"].get(row["name"], [])
    return out


def run_zoo_path(path, seed: int) -> tuple:
    """`phase_zoo` for a ZOO_PATHS or MM_PATHS path in a child process,
    waited for; its launches, in all and by variant.  torch's caching host
    allocator keeps every dump's pinned buffers for reuse, so one process
    that served every path would hold them all (the host has 96 GiB;
    jamba's dump and restore alone pin about twice its 26.6 GB image):
    each path's buffers go back to the OS when its process exits."""
    res = run_child(path[0], serve_one, path[0], seed)
    return res["launches"], res["variants"]


def fork_server():
    """The context of the script's child processes.  Each is forked from
    one server process that imported torch once (CUDA untouched, so each
    child sets up its own), so a child skips the import a fresh process
    pays (the `[time]` lines give both); torch._dynamo too, which
    ``torch.use_deterministic_algorithms`` imports.  Started at once: the
    server's imports run beside the parent's work."""
    import multiprocessing as mp
    from multiprocessing import forkserver
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch._dynamo"])
    forkserver.ensure_running()
    return ctx


def stop_fork_server() -> None:
    """Stop the fork server and the resource tracker that multiprocessing
    started beside it, and wait for both: each would exit by itself once
    it saw this process gone, but after it, so the script would end with
    processes of its own still running."""
    from multiprocessing import forkserver, resource_tracker
    for server in (forkserver._forkserver, resource_tracker._resource_tracker):
        server._stop()


def torch_settings() -> None:
    """What every process of the script runs under: deterministic
    algorithms (bitwise resume) without their NaN fill of each fresh
    allocation (a debugging aid: one extra kernel per torch.empty;
    results do not depend on it), and no TF32."""
    from repro_torch.devices import set_deterministic
    set_deterministic()


def serve_one(arch: str, seed: int, layers=None) -> dict:
    """Serve one path of SERVE_PATHS, ZOO_PATHS or MM_PATHS (at `layers`
    layers in place of its own depth, if given); its launches, in all and
    by variant."""
    paths = {p[0]: (p, "serve") for p in SERVE_PATHS}
    paths.update({p[0]: (p, "zoo") for p in ZOO_PATHS})
    paths.update({p[0]: (p, "mm") for p in MM_PATHS})
    path, tag = paths[arch]
    if layers is not None:
        path = (path[0], layers, *path[2:])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if tag == "serve":
            launches, variants = phase_serving(*path, seed, workdir,
                                               card_line())
        else:
            launches, variants = phase_zoo(path, seed, workdir, card_line(),
                                           tag)
    return {"launches": launches, "variants": variants}


def orchestrate(seed: int, layers: int = ORCH_LAYERS) -> dict:
    """Phase 6 (at `layers` layers); its paths' launches."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        return phase_orchestration(seed, workdir, card_line(), layers)


def _child(asked_at: float, what: str, out: str, fn, *args) -> None:
    log(f"[time] {what}: the child process works {time.time() - asked_at:.2f}"
        f" s after it was asked for")
    torch_settings()
    res = fn(*args)
    with open(out, "w") as f:
        json.dump(res, f)


def start_child(what: str, fn, *args):
    """fn(*args) started in a child process from the fork server (after
    `free_memory`); `join_child` waits for it."""
    free_memory(what)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    out = os.path.join(workdir, "result.json")
    proc = CHILDREN.Process(target=_child, args=(time.time(), what, out, fn,
                                                 *args))
    proc.start()
    STARTED.append(proc)
    return what, proc, workdir


def kill_children() -> None:
    """Kill the started children that are still running (a phase failed
    before it joined them) and wait for them."""
    for proc in STARTED:
        if proc.is_alive():
            proc.kill()
            proc.join()


def join_child(child, killed_ok: bool = False):
    """What a started child's fn returned, through a JSON file (None when
    the child was killed by a signal and `killed_ok`)."""
    what, proc, workdir = child
    try:
        proc.join(timeout=1000)
        if proc.is_alive():
            proc.kill()
            proc.join()
        if killed_ok and proc.exitcode and proc.exitcode < 0:
            return None
        if proc.exitcode:
            raise SystemExit(f"{what}: the child process failed (exit "
                             f"{proc.exitcode})")
        with open(os.path.join(workdir, "result.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


class Beside(threading.Thread):
    """fn(*args) on a thread of this process, beside the phases the main
    thread runs (fn drives child processes, which do the work);
    `result()` waits for it and returns what fn returned, or raises what
    it raised."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self._fn, self._args = fn, args
        self._out, self._err = None, None
        self.start()

    def run(self) -> None:
        try:
            self._out = self._fn(*self._args)
        except BaseException as e:                   # noqa: BLE001
            self._err = e

    def result(self):
        self.join()
        if self._err is not None:
            raise self._err
        return self._out


def run_child(what: str, fn, *args, killed_ok: bool = False):
    """fn(*args) in a child process from the fork server, waited for (after
    `free_memory`); what it returned, through a JSON file (None when the
    child was killed by a signal and `killed_ok`)."""
    return join_child(start_child(what, fn, *args), killed_ok)


CHILDREN = None      # fork_server()'s context, made by main()
STARTED = []         # every child process start_child started


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--path", help="serve this model of SERVE_PATHS, "
                    "ZOO_PATHS or MM_PATHS only (as the script serves it), "
                    "or run phase 8 (c) (--path elastic), phase 6 (--path "
                    "orch), phase 5 (a)-(c) (--path repl), phase 3's "
                    "qwen1.5 training (--path train), phase 10's "
                    "training of one arch of ZOO_TRAIN (--path "
                    "train-zoo/ARCH) or phase 11 (--path dist) alone, and "
                    "write its launches to --out")
    ap.add_argument("--layers", type=int, help="with --path: run it at "
                    "this many layers (tools/cut_ab.py times a depth cut)")
    ap.add_argument("--orch", action="store_true", help="run phase 6 "
                    "only and write its paths' launches to --out")
    ap.add_argument("--chaos", action="store_true", help="run phase 7 "
                    "only and write its path's launches to --out")
    ap.add_argument("--launch", action="store_true", help="run phase 8 "
                    "only and write its paths' launches to --out")
    ap.add_argument("--dryrun", action="store_true", help="run phase 9 "
                    "only and write its path's launches to --out")
    ap.add_argument("--train-zoo", action="store_true", help="run phase 10 "
                    "only and write its paths' launches to --out")
    ap.add_argument("--dist", action="store_true", help="run phase 11 "
                    "only (--path dist: at --layers) and write its path's "
                    "launches to --out")
    ap.add_argument("--out", help="with --path, --orch, --chaos, --launch, "
                    "--dryrun or --train-zoo: the launches' JSON")
    args = ap.parse_args()

    global CHILDREN
    t_import = process_age_s()
    import torch
    t_import = (t_import, process_age_s())
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch_settings()
    if args.dist:
        args.path = DIST_PATH
    if (args.launch or args.train_zoo
            or args.path in (ELASTIC_PATH, DIST_PATH)):
        CHILDREN = fork_server()
        try:
            if args.launch:
                res = phase_launch(args.seed, card_line())
            elif args.train_zoo:
                res = phase_train_zoo(args.seed)
            elif args.path == DIST_PATH:
                res = phase_dist(args.seed, card_line(),
                                 args.layers or DIST_LAYERS)
            else:
                with tempfile.TemporaryDirectory(
                        prefix="chip_smoke_") as workdir:
                    res = {ELASTIC_PATH: launch_elastic_part(
                        workdir, args.seed, card_line(),
                        args.layers or ELASTIC_LAYERS)}
            with open(args.out, "w") as f:
                json.dump(res, f)
            return 0
        finally:
            kill_children()
            stop_fork_server()
    if args.dryrun:
        cli = DryrunCLI()
        try:
            t_phase = time.perf_counter()
            res = dryrun_phase(args.seed)
            cli.check(card_line())
            log(f"[dryrun] phase 9 wall {time.perf_counter() - t_phase:.1f}"
                f" s; {card_line()}")
        finally:
            cli.stop()
        with open(args.out, "w") as f:
            json.dump(res, f)
        return 0
    if args.path == TRAIN_PATH:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            res = {TRAIN_PATH: phase_training(
                args.seed, workdir, card_line(),
                args.layers or TRAIN_LAYERS)}
        with open(args.out, "w") as f:
            json.dump(res, f)
        return 0
    if args.path and args.path.startswith(ZOO_TRAIN_PATH):
        arch = args.path[len(ZOO_TRAIN_PATH):]
        if arch not in [p[0] for p in ZOO_TRAIN]:
            ap.error(f"--path {args.path}: no such arch in ZOO_TRAIN")
        res = {args.path: train_zoo_path(arch, args.seed, args.layers)}
        with open(args.out, "w") as f:
            json.dump(res, f)
        return 0
    if args.path == REPL_PATH:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            res = {REPL_PATH: phase_replication(
                args.seed, workdir, card_line(),
                args.layers or REPL_LAYERS)}
        with open(args.out, "w") as f:
            json.dump(res, f)
        return 0
    if args.path or args.orch or args.chaos:
        res = (orchestrate(args.seed, args.layers or ORCH_LAYERS)
               if args.orch or args.path == ORCH_PATH
               else serve_one(args.path, args.seed, args.layers) if args.path
               else chaos())
        with open(args.out, "w") as f:
            json.dump(res, f)
        return 0

    CHILDREN = fork_server()
    cli = DryrunCLI()                  # phase 9 (a), beside phases 1-8
    try:
        t_start = time.perf_counter()
        card = card_line()
        log(f"[device] {torch.cuda.get_device_name(0)}; torch "
            f"{torch.__version__} cuda {torch.version.cuda}; {card}")
        def mark(what):
            log(f"[time] {what} done at {process_age_s():.1f} s")
        log(f"[time] import torch took {t_import[1] - t_import[0]:.2f} s in "
            f"this process (done {t_import[1]:.1f} s after its start)")

        rows = phase_kernels(args.seed)
        mark("phase 1 kernels")
        phase_grads(args.seed)
        mark("phase 1")
        # phase 7 beside phases 2-2c: the chaos sim is host work
        chaos_child = start_child("phase 7", chaos)
        for arch in [p[0] for p in SERVE_PATHS + ZOO_PATHS + MM_PATHS]:
            check_small_reference(arch, args.seed)
        by_path = {}
        for arch, *path in SERVE_PATHS:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
                by_path[arch] = phase_serving(arch, *path, args.seed, workdir,
                                              card)
            torch.cuda.empty_cache()
            mark(f"phase 2 {arch}")
        mark("phase 2")
        for path in ZOO_PATHS:
            by_path[path[0]] = run_zoo_path(path, args.seed)
            mark(f"phase 2b {path[0]}")
        mark("phase 2b")
        for path in MM_PATHS:
            by_path[path[0]] = run_zoo_path(path, args.seed)
            mark(f"phase 2c {path[0]}")
        mark("phase 2c")
        by_path.update({k: tuple(v)
                        for k, v in join_child(chaos_child).items()})
        mark("phase 7 (beside phases 2-2c)")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            by_path[f"{TRAIN_ARCH} train"] = phase_training(
                args.seed, workdir, card)
            by_path[f"{MAMBA_ARCH} train ({MAMBA_LAYERS} layers)"] = \
                phase_training_mamba(args.seed, workdir, card)
            mark("phase 3")
            phase_session_race(args.seed, workdir, card)
        mark("phase 4")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            by_path[f"{REPL_ARCH} replicate/migrate"] = phase_replication(
                args.seed, workdir, card)
            by_path[f"{TRAIN_ARCH} migrate ({MIG_LAYERS} layers)"] = \
                phase_migrate_training(args.seed, workdir, card)
        mark("phase 5")
        by_path.update(run_orchestration(args.seed))
        mark("phase 6")
        # phase 10 beside phases 8, 9 and 11: each drives child
        # processes of its own, one at a time; then the paths that need
        # the card alone
        zoo = Beside(phase_train_zoo, args.seed, tuple(
            p[0] for p in ZOO_TRAIN if p[0] not in ZOO_TRAIN_ALONE))
        by_path.update(phase_launch(args.seed, card))
        mark("phase 8")
        by_path.update(run_dryrun(args.seed, cli, card))
        mark("phase 9")
        by_path.update(phase_dist(args.seed, card))
        mark("phase 11")
        by_path.update(zoo.result())
        mark("phase 10 (beside phases 8, 9 and 11)")
        by_path.update(train_zoo_archs(args.seed, ZOO_TRAIN_ALONE))
        mark(f"phase 10 {', '.join(ZOO_TRAIN_ALONE)} (alone)")
        log(f"[done] chip_smoke wall time {process_age_s():.1f} s since the "
            f"process started (what the run's 1200 s limit and its 1000 s "
            f"target apply to), {time.perf_counter() - t_start:.1f} s from "
            f"after the imports; {card}")
        print(json.dumps({"kernels": kernel_rows(rows, by_path)}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    finally:
        cli.stop()
        kill_children()
        stop_fork_server()


if __name__ == "__main__":
    sys.exit(main())

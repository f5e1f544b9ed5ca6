"""repro_torch — the CRIUgpu-style checkpointing system on PyTorch and CUDA.

The port of the JAX package ``repro`` to an NVIDIA H100, one slice at a
time; it imports neither ``jax`` nor ``repro``.  Servers and trainers run
the model zoo through hand-written Hopper kernels
(``repro_torch.kernels``) and snapshot into images that the JAX package
reads, and back; the orchestrator, the serving fleet, chaos campaigns and
the observability plane run above them, and ``python -m repro_torch`` is
the CLI.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"

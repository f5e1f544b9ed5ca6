"""repro_torch — the CRIUgpu-style checkpointing system on PyTorch and CUDA.

The port of the JAX package ``repro`` to an NVIDIA H100, one slice at a
time; it imports neither ``jax`` nor ``repro``.  This slice is the serving
path: ``repro_torch.runtime.server.DecodeServer`` prefills and decodes
qwen-style dense models through hand-written Hopper kernels
(``repro_torch.kernels``) and snapshots params + KV cache + decode cursor
into images that the JAX package reads, and back.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"

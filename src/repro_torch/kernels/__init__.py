"""Hand-written Hopper kernels for the workload hot spots.

  flash_attention  CUDA C++ (``csrc/flash_attention_tc.cu``, bf16 on the
                   tensor cores; ``csrc/flash_attention.cu``, FMAs),
                   online-softmax attention forward (causal / sliding
                   window / GQA)
  ssd_scan         CUDA C++ (``csrc/ssd_scan_tc.cu``, bf16 on the tensor
                   cores; ``csrc/ssd_scan.cu``, FMAs), Mamba2 SSD chunked
                   scan carrying the SSM state across the sequence
  rmsnorm          Triton, fused normalisation in one pass over x

Each module keeps a plain PyTorch version of its kernel and a launch
counter.  ``ops`` dispatches by device (CPU -> plain, CUDA -> kernel);
``ref`` holds the naive oracles; ``build`` compiles the CUDA sources.
"""
from repro_torch.kernels import ops, ref  # noqa: F401

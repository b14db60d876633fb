"""Hand-written CUDA kernels of the port, behind one dispatch surface
(``repro_torch.kernels.registry``).

Subpackages — each ``ops.py`` holds the registered op, its plain PyTorch
version, the launcher of its CUDA kernel (``csrc/<name>.cu``) and a note
on which TPU kernel it replaces:

  fp8_gemm/         fine-grained-scaled FP8 GEMM (paper §3.1)
  moe_gemm/         grouped expert GEMM
  paged_attention/  paged MLA absorbed decode over the E4M3 page pool
"""

"""Hand-written CUDA kernels of the port, behind one dispatch surface
(``repro_torch.kernels.registry``).

Subpackages — each ``ops.py`` holds the registered op, its plain PyTorch
version, the launcher of its CUDA kernel (``csrc/<name>.cu``) and a note
on which TPU kernel it replaces:

  flash_attention/  flash bucketed-prefill attention (GQA prefill)
  fp8_gemm/         fine-grained-scaled FP8 GEMM (paper §3.1)
  logfmt/           LogFMT-nBit encode and decode (paper §3.2)
  mla_attention/    MLA absorbed decode over the dense latent ring
  moe_gemm/         grouped expert GEMM
  paged_attention/  paged MLA absorbed and GQA decode over the page pool
"""

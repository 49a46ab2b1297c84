"""Hand-written CUDA kernels for Hopper (``sm_90a``), one directory each.

  flash_attention/  causal GQA online-softmax attention (serving prefill)
  paged_attention/  one-token decode attention over a paged KV pool
  gossip_mix/       the weighted combine of a gossip round (training)
  ssd_scan/         the Mamba-2 chunked SSD scan (ssm forward)

Each has ref.py (the plain PyTorch version), kernel.py (checks, output
allocation and the ctypes launch of ``csrc/<name>.cu``) and ops.py (the
entry point: a CPU tensor takes ref.py, a CUDA tensor the kernel, and a
``launches`` counter on the wrapper).  ``build.py`` compiles the sources
with nvcc at first use.
"""

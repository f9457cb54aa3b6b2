"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Kernel families (one directory each, sources under ``csrc/``):
  * ``brgemm``          — the batch-reduce GEMM with its fused epilogue,
  * ``flash_attention`` — the online-softmax attention forward.

They build at first use (``_build.py``); importing this package builds
nothing, so it imports on a machine without a card.
"""

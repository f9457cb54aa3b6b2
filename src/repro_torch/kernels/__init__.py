"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Kernel families (one directory each, sources under ``csrc/``):
  * ``brgemm``              — the batch-reduce GEMM with its fused epilogue,
                              X and W each read row- or column-major, so
                              one kernel serves the forward and both
                              backward products;
  * ``flash_attention``     — the online-softmax attention forward;
  * ``flash_attention_bwd`` — the attention backward (dQ with delta fused,
                              dK / dV) and the standalone delta pass; its
                              wrappers live in ``flash_attention/bwd.py``;
  * ``conv2d``              — the direct convolution as an implicit GEMM
                              (forward, and the backward by data as a dual
                              convolution);
  * ``brgemm_batched``      — the stacked batch-reduce GEMM and the batched
                              GEMM; their wrappers live in
                              ``brgemm/kernel.py``;
  * ``brgemm_quant``        — the quantized GEMMs (int8, or fp8 widened to
                              bf16) with the dequant fused in the epilogue:
                              matmul_q, brgemm_q and batched_matmul_q in one
                              kernel; their wrappers live in
                              ``brgemm/quant_kernel.py``.

``include/`` holds what several families share: the tile GEMM of
``conv2d``, ``brgemm_batched`` and ``brgemm_quant`` (``repro_tile.cuh``),
Hopper's mbarrier, TMA and wgmma wrappers (``repro_sm90.cuh``), and the
wgmma + TMA GEMM mainloop and epilogue that ``matmul`` and
``batched_matmul`` share (``repro_gemm_sm90.cuh``).

They build at first use (``_build.py``); importing this package builds
nothing, so it imports on a machine without a card.
"""

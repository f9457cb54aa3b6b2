"""The batch-reduce GEMM as the single building block.

Every projection of the port's layers routes through ``matmul``: see
``repro_torch.kernels.brgemm`` for the Hopper kernel and its plain version,
and ``repro_torch.core.dispatch`` for how a call picks between them.
"""
from repro_torch.kernels.brgemm.ops import matmul  # noqa: F401

"""The batch-reduce GEMM as the single building block.

Every projection of the port's layers routes through ``matmul``; the
paper's literal interface is ``brgemm`` (``act(alpha * sum_i A_i @ B_i +
beta * C0 + bias)``, written once) and its baseline ``batched_matmul``
(``act(alpha * A_i @ B_i + bias)`` per entry).  See
``repro_torch.kernels.brgemm`` for the Hopper kernels and their plain
versions, and ``repro_torch.core.dispatch`` for how a call picks between
them.
"""
from repro_torch.kernels.brgemm.ops import (  # noqa: F401
    batched_matmul,
    brgemm,
    matmul,
)

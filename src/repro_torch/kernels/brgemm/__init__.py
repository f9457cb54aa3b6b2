"""The batch-reduce GEMM: plain version, Hopper kernel, dispatched entry."""
from repro_torch.kernels.brgemm.kernel import matmul_cuda  # noqa: F401
from repro_torch.kernels.brgemm.ops import matmul  # noqa: F401
from repro_torch.kernels.brgemm.ref import matmul_ref  # noqa: F401

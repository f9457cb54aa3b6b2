"""The batch-reduce GEMMs (matmul, the stacked brgemm, batched_matmul) and
their quantized forms: plain versions, Hopper kernels, dispatched entries."""
from repro_torch.kernels.brgemm.kernel import (  # noqa: F401
    batched_matmul_cuda,
    brgemm_stacked_cuda,
    matmul_cuda,
)
from repro_torch.kernels.brgemm.ops import (  # noqa: F401
    batched_matmul,
    brgemm,
    brgemm_bwd,
    matmul,
)
from repro_torch.kernels.brgemm.quant_kernel import (  # noqa: F401
    batched_matmul_q_cuda,
    brgemm_q_cuda,
    matmul_q_cuda,
)
from repro_torch.kernels.brgemm.quant_ref import (  # noqa: F401
    batched_matmul_q_ref,
    brgemm_q_ref,
    matmul_q_ref,
)
from repro_torch.kernels.brgemm.ref import (  # noqa: F401
    batched_matmul_ref,
    brgemm_ref,
    matmul_ref,
)

"""Flash attention: plain versions, Hopper forward and backward kernels,
dispatched entries."""
from repro_torch.kernels.flash_attention.bwd import (  # noqa: F401
    delta_rowsum_cuda,
    flash_attention_bwd_cuda,
    reset_flash_bwd_counts,
)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    flash_attention_cuda,
    reset_flash_counts,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF,
    delta_rowsum_ref,
    flash_attention_bwd_ref,
    mha_ref,
)

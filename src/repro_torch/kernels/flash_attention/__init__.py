"""Flash attention: plain version, Hopper forward kernel, dispatched entry."""
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import NEG_INF, mha_ref  # noqa: F401

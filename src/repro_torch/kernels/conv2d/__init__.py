"""The direct convolution: plain versions, Hopper kernel, dispatched entry
with its dual-convolution backward."""
from repro_torch.kernels.conv2d.kernel import conv2d_cuda  # noqa: F401
from repro_torch.kernels.conv2d.ops import (  # noqa: F401
    conv2d,
    conv2d_bwd,
    dual_operands,
)
from repro_torch.kernels.conv2d.ref import (  # noqa: F401
    conv2d_loops_ref,
    conv2d_ref,
)

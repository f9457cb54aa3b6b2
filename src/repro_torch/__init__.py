"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors the JAX package's module names (``configs``, ``core``,
``kernels``, ``layers``, ``models``, ``serve``, ``train``, ``data``,
``checkpoint``, ``launch``, ``sharding``, ``distributed``) and imports
nothing of it or of JAX.  Every
Pallas kernel on a ported path is a hand-written CUDA kernel
(``kernels/*/csrc``), built at first use, beside a plain PyTorch
version; ``core.dispatch`` picks between them, and ``use(quant=...)`` or
a calibrated model (``quant.calibrate_params``) runs the GEMMs quantized.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from repro_torch.core.dispatch import (  # noqa: F401
    resolve,
    resolve_quant,
    use,
)
from repro_torch.core.quantize import (  # noqa: F401
    QuantConfig,
    QuantizedTensor,
    calibrate_params,
    quantize_weight,
)

__version__ = "0.1.0"

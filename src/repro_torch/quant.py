"""Public quantization API: ``repro_torch.quant``.

One import surface for quantized execution, as ``repro.quant``:

    import repro_torch
    from repro_torch import quant

    qmodel = quant.calibrate_params(model, "int8")     # offline weights
    with repro_torch.use(quant="int8"):                # dynamic activations
        logits = qmodel(tokens)                        # no call-site change

See ``repro_torch.core.quantize`` for the config and calibration, and
``repro_torch.kernels.brgemm.quant`` for the quantized GEMMs.
"""
from repro_torch.core.quantize import (  # noqa: F401
    QuantConfig,
    QuantizedTensor,
    as_quant_config,
    calibrate_params,
    default_calibrate_predicate,
    dequantize,
    quantize,
    quantize_weight,
)

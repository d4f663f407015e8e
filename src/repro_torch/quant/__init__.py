"""Quantization substrate: uniform affine quantizers, STE fake-quant,
integer helpers, PTQ calibration."""
from .quantizer import (QuantSpec, compute_scale, quantize_int,  # noqa: F401
                        dequantize, fake_quant, fake_quant_dynamic,
                        to_int_dtype, int_matmul, pack_weights_int8)
from .calibrate import (MinMaxObserver, PercentileObserver,  # noqa: F401
                        calibrate_model)

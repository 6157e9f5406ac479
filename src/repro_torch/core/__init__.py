"""Quantization core: 2-bit packing, ternary/int8 quantization, parameters
and the BitLinear layer (the ported subset of ``repro.core``)."""

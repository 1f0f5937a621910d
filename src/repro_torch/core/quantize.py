"""Format casts for (1, 8, m) floating-point storage formats (Table II).

All formats share FP32's sign/exponent layout, so a cast is mantissa
truncation or rounding (paper §VII: "type-conversion is simply a matter of
bit-truncation or bit-extension"); values stay float32.  The port of
``repro.core.quantize``: numpy arrays take the numpy helpers, tensors the
torch twins, bitwise alike.
"""
from __future__ import annotations

import numpy as np
import torch

from .float_bits import (MNT_BITS, np_round_mantissa, np_truncate_mantissa,
                         torch_round_mantissa, torch_truncate_mantissa)


def quantize_format(x, mantissa_bits: int, rounding: str = "truncate"):
    """Cast ``x`` (a numpy array or a tensor) to the (1, 8, mantissa_bits)
    format, kept in float32; ``rounding`` is "truncate" or "nearest" (RNE)."""
    if rounding == "truncate":
        fn = np_truncate_mantissa if isinstance(x, np.ndarray) else torch_truncate_mantissa
    elif rounding == "nearest":
        fn = np_round_mantissa if isinstance(x, np.ndarray) else torch_round_mantissa
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return fn(x, mantissa_bits)


def stochastic_round_format(x: torch.Tensor, mantissa_bits: int,
                            generator: torch.Generator | None = None) -> torch.Tensor:
    """Stochastic mantissa rounding to ``mantissa_bits`` (beyond the paper;
    useful for low-M training): |x| is truncated after adding a uniform
    draw from ``generator`` of up to one unit in the last kept place, so
    the result is the truncation of x or the next value away from zero,
    the latter with probability (|x| - trunc) / ulp.  The draws cannot
    match JAX's threefry, so only these properties carry over."""
    if mantissa_bits >= MNT_BITS:
        return x.to(torch.float32)
    x = x.to(torch.float32)
    ulp = torch.abs(torch_truncate_mantissa(x, mantissa_bits)) * (2.0 ** (-mantissa_bits))
    noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=x.device) * ulp
    return torch_truncate_mantissa(x + torch.sign(x) * noise, mantissa_bits)

"""Rounding to TF32, the precision below fp32 that the control's products
take: 10 bits of mantissa, as the tensor cores read an fp32 operand when
TF32 is on, rounded to nearest with ties to even. The result is an fp32
tensor, so the product after it runs in fp32.
"""

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)

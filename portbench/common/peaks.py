"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit).  A roofline share states the card's power
limit beside it."""

#: HBM3 bandwidth, bytes per second.
HBM_BYTES_PER_S = 3.35e12

#: FP32 outside the tensor cores, and TF32 on them, FLOP per second.
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

#: The fastest float32-accurate route through the tensor cores: each
#: product split into TF32 parts and formed as three TF32 products
#: (3xTF32), so a third of the TF32 rate.
F32_ACCURATE_FLOP_PER_S = TF32_FLOP_PER_S / 3


def floor_s(nbytes: float, flops: float,
            flop_per_s: float = F32_ACCURATE_FLOP_PER_S) -> float:
    """The least time a piece of work could take: the larger of its bytes
    over the memory rate and its operations over ``flop_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)

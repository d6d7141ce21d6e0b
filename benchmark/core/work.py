"""Work counts for rooflines, and the card's published peaks.

A field's operations a point come from its scene (`op_counts`); each
kind costs, in float32 operations, (value, once where partials are
formed, each partial). A `min` or `max` selects its partials and costs
none for them; so does a constant's subtraction. Bytes are each output
byte written once; the coordinates are formed from the pixel's index,
and the parameters are a few bytes.
"""

COST = {
    "add": (1, 0, 1),
    "sub": (1, 0, 1),
    "sub_imm": (1, 0, 0),
    "square": (1, 1, 1),  # 2 v once, then a product a partial
    "sqrt": (1, 1, 1),  # 1 / (2 s) once, then a product a partial
    "abs": (1, 0, 1),
    "max": (1, 0, 0),
    "min": (1, 0, 0),
}

#: NVIDIA H100 SXM, the data sheet's dense rates at 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def flops_per_point(counts: dict, partials: int = 0) -> int:
    """Float32 operations a point: the value, and `partials` partial
    derivatives beside it."""
    total = 0
    for kind, n in counts.items():
        value, shared, each = COST[kind]
        total += n * value
        if partials:
            total += n * (shared + each * partials)
    return total


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)

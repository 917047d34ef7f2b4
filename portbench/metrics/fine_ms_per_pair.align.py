"""Device milliseconds a pair launched inside the program's span
`rf.align.fine` (the fine features, the warp and the heads, kernels 5h,
6, 7, 8 and 9) in the traced window."""

from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "align", "rf.align.fine", "units")

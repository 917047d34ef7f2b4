"""Device milliseconds a pair launched inside the program's span
`rf.align.matching` (the batched score, kernel 2, the match arrays) in the
traced window."""

from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "align", "rf.align.matching", "units")

"""Device milliseconds a call (one pair) launched inside the program's span
`rf.align.fine` (the fine stage) in the traced window."""

from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "align", "rf.align.fine", "calls")

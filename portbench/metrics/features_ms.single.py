"""Device milliseconds a call (one pair) launched inside the program's span
`rf.align.features` (the trunk over the source pyramid's scales and the
target) in the traced window."""

from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "align", "rf.align.features", "calls")

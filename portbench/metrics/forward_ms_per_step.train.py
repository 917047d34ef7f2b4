"""Device milliseconds a step launched inside the program's span
`rf.train.forward` (the losses' forward) in the traced window."""

from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "train", "rf.train.forward", "calls")

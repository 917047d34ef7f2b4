"""Device milliseconds a step launched inside the program's span
`rf.train.backward` (autograd's backward, from its own thread, while the
main thread is inside the span) in the traced window."""

from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "train", "rf.train.backward", "calls")

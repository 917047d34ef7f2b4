"""Milliseconds a step in which the device ran nothing while the host was
inside the program's span `rf.train.backward`, in the traced window."""

from portbench.stages import idle_ms


def read(ctx):
    return idle_ms(ctx, "train", "rf.train.backward", "calls")

"""Share of the traced window in which no operation ran on the device."""

from portbench.metrics_common import idle_pct


def read(ctx):
    return idle_pct(ctx)

"""Launches of the trunk's convolution epilogue (kernel 14, the program's
launch counter `conv_epilogue`) a call in the traced window: 40 a trunk
pass, over the 7 source scales and the target. None where the program has
no such counter."""


def read(ctx):
    trec = ctx.get("trace_rec")
    if trec is None or "conv_epilogue" not in trec["launches"] or not trec["calls"]:
        return None
    return trec["launches"]["conv_epilogue"] / trec["calls"]

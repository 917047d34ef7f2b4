"""Launches of the fine networks' convolution kernel (kernel 15, the
program's launch counter `fine_conv`) a call in the traced window: 42 a
fine pass (15 for each of the two extractor passes, 4 for each of the three
head trunks). None where the program has no such counter."""


def read(ctx):
    trec = ctx.get("trace_rec")
    if trec is None or "fine_conv" not in trec["launches"] or not trec["calls"]:
        return None
    return trec["launches"]["fine_conv"] / trec["calls"]

"""`mfu.<kind>`: the model FLOPs the traced window completed (a
triplet's count from the configuration's layer shapes, counts/model.py,
times the triplets) over the window's seconds times the chip's peak for
the compute type, in %. Read in cells of that kind only."""

from b2f_bench.counts.ops import PEAK_FLOPS


def read(ctx: dict, part: str):
    if ctx["kind"] != part or ctx["seconds"] <= 0:
        return None
    peak = PEAK_FLOPS[ctx["element_bytes"]]
    return 100.0 * ctx["flops_per_triplet"] * ctx["triplets"] / (ctx["seconds"] * peak)

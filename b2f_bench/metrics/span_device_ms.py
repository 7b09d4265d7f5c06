"""`span_device_ms.<kind>.<span>`: the device ms an iteration of the
kernels, copies and memsets that the program's span `<span>` holds, the
spans inside it included, in the traced host slice (spans.py). Nothing
to read in a cell of another kind, where the program opens no such span,
or where the slice holds no device time (the CPU)."""


def read(ctx: dict, part: str):
    kind, _, name = part.partition(".")
    spans = ctx.get("spans")
    if ctx["kind"] != kind or not spans or name not in spans:
        return None
    if spans["outside"]["of_device_ms"] <= 0:
        return None
    return spans[name]["device_ms"]

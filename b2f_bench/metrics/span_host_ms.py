"""`span_host_ms.<kind>.<span>`: the host ms an iteration inside the
program's span `<span>`, from the program's own span table over the
traced device slice, where the profiler records the device alone and
costs the host least (spans.py). Nothing to read in a cell of another
kind, or where the program opens no such span."""


def read(ctx: dict, part: str):
    kind, _, name = part.partition(".")
    table = ctx.get("span_host")
    if ctx["kind"] != kind or not table or name not in table:
        return None
    return table[name]["host_ms"]

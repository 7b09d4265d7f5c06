"""`device_idle.<kind>`: the share of the traced window in which no
kernel, copy or memset ran on the device, in % (trace.py)."""


def read(ctx: dict, part: str):
    if ctx["kind"] != part or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])

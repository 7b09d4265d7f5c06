"""`enqueue_ms.<kind>`: the host's time from the call of the timed entry
(a serving forward, a train step) to its return, before any
synchronise, as a mean over the traced window's iterations, in ms. Where
the host runs ahead of the device until the launch queue fills, the
call waits there, and this reads the device's pace."""


def read(ctx: dict, part: str):
    if ctx["kind"] != part or not ctx["enqueue_s"]:
        return None
    return 1e3 * sum(ctx["enqueue_s"]) / len(ctx["enqueue_s"])

"""The device's idle share of a training iteration, in %: 1 - the device's
busy seconds in the traced iteration (the union of the device operations'
intervals, torch.profiler) over the mean host seconds of an iteration the
profiler did not cover (its collect and update spans, between
synchronizes). The profiler slows the host-bound collect; every iteration
does the same device work, so its busy seconds are read there and the
time from the others."""
UNIT = "%"
LAYER = "device"
MOVES = "train_agent_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx.get("trace")
    c, u = (ctx.get("collect_s") or [])[1:], (ctx.get("update_s") or [])[1:]
    if tr is None or not tr.launches() or not c:
        return None
    return 100.0 * (1.0 - tr.busy_s() / ((sum(c) + sum(u)) / len(c)))

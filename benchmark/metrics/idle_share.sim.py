"""The device's idle share of a step, in %: 1 - the device's busy seconds
per step over the host seconds per step. The busy seconds (the union of
the device operations' intervals, torch.profiler) and their steps are the
traced stretch's; the host seconds and their steps are the rest of the
window's, which the profiler's own host work does not slow."""
UNIT = "%"
LAYER = "device"
MOVES = "sim_agent_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.launches() or not ctx.get("traced_steps") \
            or not ctx.get("untraced_steps"):
        return None
    busy_per_step = tr.busy_s() / ctx["traced_steps"]
    return 100.0 * (1.0 - busy_per_step * ctx["untraced_steps"] / ctx["untraced_s"])

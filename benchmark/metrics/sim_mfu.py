"""The whole step's share of the card's peak, in %: the surrogate's
operations per aircraft (from the configuration's widths) x aircraft x
steps, over their seconds x the peak of the surrogate's stated precision;
steps and seconds of the traced run's window after the profiler's stretch
(the host clock between synchronizes). Whatever implements the step, it
reads the same work."""
from benchmark import counts

UNIT = "%"
LAYER = "model step"
MOVES = "sim_agent_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    if not ctx.get("untraced_steps"):
        return None
    s = ctx["config"]["surrogate"]
    flops = counts.surrogate_flops(s) * ctx["aircraft"] * ctx["untraced_steps"]
    return 100.0 * flops / counts.PEAK_FLOPS[s["precision"]] / ctx["untraced_s"]

"""The whole training iteration's share of the card's peak, in %: for
each precision the configuration states, the operations its networks and
surrogate need per iteration (`counts.train_iteration_flops`) over that
precision's peak, summed, over an iteration's seconds: the collect and
update spans of the traced run's iterations that the profiler did not
cover (of all of them where it covered every one)."""
from benchmark import counts

UNIT = "%"
LAYER = "model step"
MOVES = "train_agent_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    per_iter = counts.peak_seconds(counts.train_iteration_flops(
        ctx["config"], ctx["obs_dim"], ctx["act_dim"]))
    c, u = ctx.get("collect_s") or [], ctx.get("update_s") or []
    if len(c) > 1:
        c, u = c[1:], u[1:]
    if not c:
        return None
    return 100.0 * per_iter * len(c) / (sum(c) + sum(u))

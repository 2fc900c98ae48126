"""Seconds per update: the host time of each `F16SimRunner.train` (16
epochs of minibatch steps) in the traced run's window, between
synchronizes; the mean over the updates the profiler did not cover (all of
them where it covered every one)."""
UNIT = "s"
LAYER = "policy and update"
MOVES = "train_agent_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    times = ctx.get("update_s") or []
    times = times[1:] if len(times) > 1 else times
    if not times:
        return None
    return sum(times) / len(times)

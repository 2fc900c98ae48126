"""Milliseconds per step of the collect: the host time of each
`F16SimRunner.collect` in the traced run's window, between synchronizes,
over its `buffer_size` steps; the mean over the collects the profiler did
not cover (all of them where it covered every one)."""
UNIT = "ms"
LAYER = "trainer loop"
MOVES = "train_agent_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    times = ctx.get("collect_s") or []
    times = times[1:] if len(times) > 1 else times
    if not times:
        return None
    return sum(times) / len(times) / ctx["T"] * 1e3

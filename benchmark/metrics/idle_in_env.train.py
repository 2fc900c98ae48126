"""Of the device's idle time inside the profiled `runner.collect` (the
complement of the union of the trace's device operations), the share in %
during which the innermost open program span was `env.step`. The rest,
under the collect's own time, is its buffer writes, flags and counters."""
from benchmark import program_spans

UNIT = "%"
LAYER = "device"
MOVES = "train_agent_steps_per_s"
SOURCE = "program_span"


def read(ctx):
    return program_spans.idle_share(ctx, program_spans.ENV)

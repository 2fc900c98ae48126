"""Host milliseconds of the env step per collected step: the time inside
the program's `env.step` spans (`Env.step`: the `env_step` kernel and its
glue) within the profiled `runner.collect`, over its `buffer_size` steps.
Profiled time: torch.profiler slows the host."""
from benchmark import program_spans

UNIT = "ms"
LAYER = "host dispatch of the collect"
MOVES = "train_agent_steps_per_s"
SOURCE = "program_span"


def read(ctx):
    return program_spans.host_ms_per_step(ctx, program_spans.ENV)

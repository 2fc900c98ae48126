"""Host milliseconds of the policy's act per collected step: the time
inside the program's `policy.act` spans (`PPOPolicy.get_actions`: the GRU
actor and critic and the sampling) within the profiled `runner.collect`,
over its `buffer_size` steps. Profiled time: torch.profiler slows the host."""
from benchmark import program_spans

UNIT = "ms"
LAYER = "host dispatch of the collect"
MOVES = "train_agent_steps_per_s"
SOURCE = "program_span"


def read(ctx):
    return program_spans.host_ms_per_step(ctx, program_spans.ACT)

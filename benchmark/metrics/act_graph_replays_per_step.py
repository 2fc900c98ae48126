"""CUDA-graph replays of the policy's act per collected step: the
`policy.act.replay` spans inside the `policy.act` spans of the profiled
`runner.collect`, over its `buffer_size` steps. 0 where that collect
replays no graph (it runs the act eagerly); None where there is no
profiled collect to read."""
from benchmark import program_spans

UNIT = "replays"
LAYER = "host dispatch of the collect"
MOVES = "train_agent_steps_per_s"
SOURCE = "program_span"
REPLAY = "policy.act.replay"


def read(ctx):
    got = program_spans.profiled(ctx, program_spans.COLLECT, "collect")
    if got is None:
        return None
    i, found = got
    acts = {k for k, s in enumerate(found) if s.parent == i and s.name == program_spans.ACT}
    return sum(s.name == REPLAY and s.parent in acts for s in found) / ctx["T"]

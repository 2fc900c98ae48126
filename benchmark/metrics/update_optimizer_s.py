"""Seconds of the profiled update's optimizer phase on the stream: the
program's `trainer.optimizer` (the gradient norms, the clip and the Adam step)
timed between two CUDA events on the current stream, summed over the
`trainer.update`'s minibatches. Where the profiled host falls behind the
stream, the phase's time includes that idle time."""
from benchmark import program_spans

UNIT = "s"
LAYER = "policy and update"
MOVES = "train_agent_steps_per_s"
SOURCE = "program_span"


def read(ctx):
    return program_spans.phase_s(ctx, "trainer.optimizer")

"""Device operations (kernels, copies, sets) that torch.profiler saw begin
inside the traced collect, per collected step: the host's dispatch of the
env step, the policy's forward and the sampling."""
UNIT = "launches"
LAYER = "host dispatch of the collect"
MOVES = "train_agent_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    n = tr.launches("collect")
    return n / ctx["T"] if n else None

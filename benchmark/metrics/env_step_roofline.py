"""The step kernel's share of its roofline, in %: the least time one step
of the cell's aircraft can take (`counts.env_step_bound_s`: the larger of
the surrogate's operations at the bf16 peak and the step's bytes at the
memory's peak) over the kernel's mean device time in the trace."""
from benchmark import counts

UNIT = "%"
LAYER = "kernels"
MOVES = "sim_agent_steps_per_s"
SOURCE = "device_trace"
KERNELS = ("env_step_kernel", "env_step_grouped_kernel")


def read(ctx):
    tr = ctx.get("trace")
    times = tr.kernel_times(KERNELS) if tr is not None else []
    if not times:
        return None
    bound = counts.env_step_bound_s(ctx["config"]["surrogate"], ctx["aircraft"])
    return 100.0 * bound / (sum(times) / len(times))

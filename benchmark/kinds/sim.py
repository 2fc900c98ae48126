"""Traffic kind "sim": the simulator alone (`benchmark/sim.py`)."""
from benchmark.sim import SimRun as Run  # noqa: F401

MODES = ("program", "control", "fault:unchanged", "fault:altered")


def tiny(cell: dict) -> dict:
    cell["traffic"].update(aircraft=256, check_rows=128, check_within=40, warmup_steps=2)
    return cell

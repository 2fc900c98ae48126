"""Traffic kind "train": PPO training (`benchmark/training.py`)."""
from benchmark.training import TrainRun as Run  # noqa: F401

MODES = ("program", "control", "fault:unchanged", "fault:altered", "fault:half")


def tiny(cell: dict) -> dict:
    cell["config"].update(n_rollout_threads=6, buffer_size=16, data_chunk_length=4,
                          num_mini_batch=3, ppo_epoch=2)
    cell["traffic"].update(check_envs=4)
    return cell

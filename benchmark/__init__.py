"""The benchmark of neuralplane_tpu_torch, the PyTorch and CUDA port, on
one NVIDIA H100: `python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of `BENCHMARK.json` once.

It imports neither JAX nor the JAX package; of the port it takes only the
system under test (`program.py`, `sim.py`, `training.py`), reached through
the driver of each traffic kind (`kinds/`). The yardstick lives here: the
traffic (`traffic/`), the configurations (`configs/`), the plain reference
(`reference/`), the comparison and its limits (`judge.py`, `limits/`), the
counts and peaks (`counts.py`) and the per-layer readers (`metrics/`).
"""

"""PyTorch/CUDA port of neuralplane_tpu for one NVIDIA H100.

The package mirrors `neuralplane_tpu`'s module names. It imports torch and
numpy only: nothing of JAX and nothing of the JAX package. It reads the JAX
package's data files (scenario YAMLs, the distilled aero npz) by path.

Every entry point takes `device=` and defaults to "cuda"; there is no silent
CPU fallback. On a CUDA tensor a kernel wrapper launches its hand-written
Hopper kernel (`csrc/`, built with nvcc at first use) or raises; on a CPU
tensor it runs the kernel's plain PyTorch version.
"""
from .envs import ControlEnv, Env

__all__ = ["ControlEnv", "Env"]

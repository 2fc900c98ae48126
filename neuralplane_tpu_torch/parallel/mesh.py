"""Data-parallel mesh, sharding and collectives over torch.distributed
(counterpart of neuralplane_tpu/parallel/mesh.py).

The JAX package shards one global array over a device mesh that one process
drives, and XLA inserts the gradient all-reduce. The port runs one process
per rank (`torchrun`; `torch.multiprocessing` in the tests). Each rank
builds its share of the env batch in whole env groups, so combat pairing
stays on the rank. The policy and the optimizer are replicated from rank 0.
Every place where the JAX package reduces over the global batch is an
explicit collective here: the gradient mean of each minibatch, the
advantage normalization, MAPPO's count of active agents, the logged counts
and the ELO eval's per-slice sums.

`Mesh` is a rank's place: rank, size, device and process group. Outside
torch.distributed the group is None and every collective is the identity.
Only `all_reduce` and `broadcast` touch tensors, the two operations gloo
supports on CUDA tensors, so ranks that share one card run over gloo.
A collective flattens its tensors into one buffer per dtype, so a
minibatch's gradients cost one call and not one per leaf; `Mesh.stats`
counts the calls and their host seconds.

`shard_batch`, `shard_batch_tree` and `shard_env_state` cut a global tensor,
tree or env state into this rank's contiguous slice, by the JAX package's
axis rule.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def _new_stats() -> Dict[str, float]:
    return {"all_reduce_calls": 0, "all_reduce_s": 0.0, "broadcast_calls": 0}


@dataclasses.dataclass
class Mesh:
    """A rank's place in the 1-D data-parallel mesh over `axis_name`."""
    device: torch.device
    rank: int = 0
    size: int = 1
    axis_name: str = "dp"
    group: Optional[Any] = None   # a ProcessGroup; None: collectives are the identity
    owns_group: bool = False      # `close` destroys the group
    stats: Dict[str, float] = dataclasses.field(default_factory=_new_stats)

    def close(self) -> None:
        """Destroy the process group if this mesh's maker created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.group, self.owns_group = None, False


def local_device(device="cuda") -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    cuda:(LOCAL_RANK mod the card count), so ranks beyond the cards share
    them; any other device is returned as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not torch.cuda.is_available():
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                        % torch.cuda.device_count())


def make_mesh(device="cuda", axis_name: str = "dp", owns_group: bool = False) -> Mesh:
    """The mesh over every rank of the initialized process group; size 1
    and no group when torch.distributed is not initialized."""
    dev = local_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(device=dev, axis_name=axis_name)
    return Mesh(device=dev, rank=dist.get_rank(), size=dist.get_world_size(),
                axis_name=axis_name, group=dist.group.WORLD, owns_group=owns_group)


# ---- trees of tensors (dataclasses, dicts, lists, tuples) ----
def tree_map(fn: Callable, tree):
    """`fn` on every tensor leaf; other leaves as they are."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # a NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


# ---- sharding ----
def shard_count(n: int, mesh: Mesh) -> int:
    """This rank's share of n rows; n must divide over the mesh."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks")
    return n // mesh.size


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of x along `axis`, as a contiguous copy."""
    k = shard_count(x.shape[axis], mesh)
    return x.narrow(axis, mesh.rank * k, k).clone(memory_format=torch.contiguous_format)


def shard_batch_tree(tree, ns, mesh: Mesh):
    """Shard every leaf on an axis whose size is in `ns` (int or tuple), the
    rest as they are. Among such axes the largest, on a tie the last: the
    feature rows of a feature-major leaf (F16StateFM's [12, n]) can equal a
    small batch size, and the agent axis is the larger of the two
    (neuralplane_tpu/parallel/mesh.py:41-66)."""
    ns = (ns,) if isinstance(ns, int) else tuple(ns)

    def place(leaf):
        cands = [(dim, ax) for ax, dim in enumerate(leaf.shape) if dim in ns]
        if not cands:
            return leaf
        return shard_batch(leaf, mesh, axis=max(cands)[1])
    return tree_map(place, tree)


def shard_env_state(state, mesh: Mesh):
    """Shard an env state or a rollout carry on its agent axis: the [n]
    leaves of the env state and a self-play carry's [n/2] ego leaves alike
    (neuralplane_tpu/parallel/mesh.py:69-79)."""
    if hasattr(state, "step_count"):
        n = state.step_count.shape[0]
    elif hasattr(state, "env_state"):
        n = state.env_state.step_count.shape[0]
    else:
        raise ValueError("cannot infer the batch size; use shard_batch_tree")
    return shard_batch_tree(state, (n, n // 2), mesh)


# ---- collectives ----
def _collective(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh],
                op: Callable[[torch.Tensor], None]) -> List[torch.Tensor]:
    """Run `op` on one flat buffer per dtype on the mesh's device and copy
    the result back into `tensors` in place."""
    tensors = list(tensors)
    if mesh is None or mesh.group is None or not tensors:
        return tensors
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1).to(mesh.device) for t in ts])
            op(flat)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
    return tensors


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
                   ) -> List[torch.Tensor]:
    """Sum each tensor over the ranks, in place; returns the list."""
    def op(flat):
        t0 = time.perf_counter()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        mesh.stats["all_reduce_calls"] += 1
        mesh.stats["all_reduce_s"] += time.perf_counter() - t0
    return _collective(tensors, mesh, op)


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
                    ) -> List[torch.Tensor]:
    """Average floating tensors over the ranks, in place; returns the list."""
    out = all_reduce_sum(tensors, mesh)
    if mesh is not None and mesh.group is not None and mesh.size > 1:
        with torch.no_grad():
            for t in out:
                t.div_(mesh.size)
    return out


def broadcast(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh], src: int = 0
              ) -> List[torch.Tensor]:
    """Rank `src`'s values into every rank's tensors, in place."""
    def op(flat):
        dist.broadcast(flat, src=src, group=mesh.group)
        mesh.stats["broadcast_calls"] += 1
    return _collective(tensors, mesh, op)


def replicate(x, mesh: Optional[Mesh], src: int = 0):
    """Make rank `src`'s copy of x every rank's, in place: a module's
    parameters and buffers, an optimizer's state tensors (in the order of
    its parameters) or a tree of tensors. Returns x."""
    if isinstance(x, torch.nn.Module):
        tensors = [*x.parameters(), *x.buffers()]
    elif isinstance(x, torch.optim.Optimizer):
        tensors = [v for g in x.param_groups for p in g["params"]
                   for _, v in sorted(x.state.get(p, {}).items()) if torch.is_tensor(v)]
    else:
        tensors = tree_leaves(x)
    broadcast(tensors, mesh, src)
    return x


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (a no-op without a process group)."""
    if mesh is None or mesh.group is None:
        return
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)

"""Process-group initialization and the global mesh (counterpart of
neuralplane_tpu/parallel/distributed.py).

The JAX package wires the hosts of a pod slice into one JAX process group
and builds one mesh over every chip. The port runs one process per rank:
`init_distributed` wires them with `torch.distributed.init_process_group`,
and `make_global_mesh` gives each its place in the 1-D "dp" mesh
(parallel/mesh.py).

The backend follows one rule (`choose_backend`), applied to the cards the
ranks actually hold: each rank publishes its card's UUID (`card_id`) to the
rendezvous store, and the group is NCCL when every rank holds a card and no
two hold the same one; gloo otherwise, that is on the CPU or when ranks
share a card (NCCL refuses two ranks on one card). So one card per rank
through CUDA_VISIBLE_DEVICES runs NCCL, and ranks given the same explicit
index (`cuda:0`) run gloo. Nothing falls back: a failed initialization
raises.

Sampled trajectories depend on the world size here, unlike the JAX
package's (:13-15): each rank draws from its own generator (runner/base.py:
rank_seed), and world size 1 is the run without a mesh, bit for bit.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, local_device, make_mesh


def card_id(device="cuda") -> Optional[str]:
    """The UUID of the card `device` lies on; None off CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(dev).uuid)


def choose_backend(card_ids: Sequence[Optional[str]]) -> str:
    """The backend rule over every rank's `card_id`: "nccl" when each rank
    holds a card and no two hold the same one, else "gloo"."""
    if all(c is not None for c in card_ids) and len(set(card_ids)) == len(card_ids):
        return "nccl"
    return "gloo"


def exchange_card_ids(store, rank: int, world: int, card: Optional[str]
                      ) -> List[Optional[str]]:
    """Publish this rank's card to the rendezvous store and read every
    rank's, in rank order (each read waits for its rank)."""
    store.set(f"neuralplane/card/{rank}", card or "")
    return [store.get(f"neuralplane/card/{r}").decode() or None for r in range(world)]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda") -> bool:
    """Initialize torch.distributed; a no-op at one process or when a group
    exists. Returns whether this call created the group.

    With no arguments it reads the launcher's (`torchrun`'s) RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT; `coordinator_address` is
    "host:port" or a URL such as "tcp://localhost:12355". `device` is this
    rank's device (`local_device` resolves a bare "cuda"); the cards of all
    ranks pick the backend (`choose_backend`)."""
    if dist.is_initialized():
        return False
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world <= 1:
        return False
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store, rank, world = next(dist.rendezvous(init_method, rank, world,
                                              timeout=dist.default_pg_timeout))
    backend = choose_backend(exchange_card_ids(store, rank, world, card_id(dev)))
    dist.init_process_group(backend, store=store, world_size=world, rank=rank)
    logging.info("torch.distributed: rank %d of %d on %s, backend %s", rank, world, dev,
                 backend)
    return True


def make_global_mesh(device="cuda", axis_name: str = "dp") -> Mesh:
    """`init_distributed()` from the launcher's environment, then the mesh
    over every rank; the mesh owns the group if this call created it, and
    is of size 1 without a launcher."""
    made = init_distributed(device=device)
    return make_mesh(device, axis_name, owns_group=made)

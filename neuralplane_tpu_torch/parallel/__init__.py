from .distributed import (card_id, choose_backend, exchange_card_ids, init_distributed,
                          make_global_mesh)
from .mesh import (Mesh, all_reduce_mean, all_reduce_sum, barrier, broadcast, local_device,
                   make_mesh, replicate, shard_batch, shard_batch_tree, shard_count,
                   shard_env_state)

__all__ = ["Mesh", "all_reduce_mean", "all_reduce_sum", "barrier", "broadcast", "card_id",
           "choose_backend", "exchange_card_ids", "init_distributed", "local_device",
           "make_global_mesh", "make_mesh", "replicate", "shard_batch", "shard_batch_tree",
           "shard_count", "shard_env_state"]

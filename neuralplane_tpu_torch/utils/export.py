"""Policy export for serving: a trained actor -> a `torch.export` artifact
(counterpart of neuralplane_tpu/utils/export.py, which writes StableHLO).

The deterministic inference step of a trained actor - `(obs, h, mask) ->
(action, h')`, the mean of a Box policy or the mode of each head of a
HeadActor (with the shoot head's Beta prior, where the policy has one) - is
exported with the parameters baked in and saved by `torch.export.save` (a
`.pt2` file). A consumer loads it with `torch.export.load` and calls
`.module()` with no knowledge of this package: no policy classes, no
parameter dicts. The JAX package cannot read the artifact, and this package
does not read the JAX package's StableHLO.

The batch dimension is symbolic ("b"): the program is traced at an example
batch of `example_batch` > 1 (torch.export specializes a dimension whose
example size is 1), so one artifact serves any fleet size. The GRU hidden
state is an explicit input and output. The artifact runs on the device the
policy was on when it was exported.
"""
from __future__ import annotations

import io
from typing import Callable, Tuple

import torch
from torch import nn

from ..algorithms.networks import init_rnn_state


class _Infer(nn.Module):
    def __init__(self, actor: nn.Module):
        super().__init__()
        self.actor = actor

    def forward(self, obs: torch.Tensor, h: torch.Tensor, mask: torch.Tensor):
        dist, h2 = self.actor.dist_step(obs, h, mask)
        return dist.mode(), h2


def export_actor(policy, example_batch: int = 8) -> bytes:
    """Serialize the deterministic actor step of `policy` (a PPOPolicy or
    MAPPOPolicy) with its parameters folded in; load with `load_actor`."""
    if example_batch < 2:
        raise ValueError("example_batch must be > 1 (a size-1 example is specialized)")
    dev = policy.device
    obs = torch.zeros((example_batch, policy.spec.obs_dim), device=dev)
    h = init_rnn_state(example_batch, policy.spec, dev)
    mask = torch.ones((example_batch, 1), device=dev)
    b = torch.export.Dim("b")
    with torch.no_grad():
        ep = torch.export.export(_Infer(policy.actor).eval(), (obs, h, mask),
                                 dynamic_shapes={"obs": {0: b}, "h": {0: b}, "mask": {0: b}})
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_actor(blob: bytes) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Deserialize an exported actor into a callable
    `(obs[b,obs], h[b,L,H], mask[b,1]) -> (action[b,act], h'[b,L,H])`."""
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(obs, h, mask):
        with torch.no_grad():
            return module(obs.float(), h, mask.float())
    return call

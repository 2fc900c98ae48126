"""Actor and critic networks as nn.Modules (counterpart of
neuralplane_tpu/algorithms/networks.py).

Architecture, as in the JAX package:
  Trunk:  optional input LayerNorm, then the base MLP [Linear -> act ->
          LayerNorm] per hidden size (`_mlp` :158), then, when recurrent,
          stacked torch-convention GRU cells (gates r, z, n) with a per-step
          `h * mask` reset (`_gru_step` :177-186) and an output LayerNorm.
  Actor:  trunk, optional MLP, mean = tanh(Linear) and a state-independent
          learnable log_std, clamped from below by min_log_std (:266-274).
  Critic: trunk, optional MLP, scalar value Linear.

`actor_step` / `critic_step` run one step, h [N, layers, H], mask [N, 1].
`actor_seq` / `critic_seq` run the base MLP once over [T, N, D] and then the
GRU cells in a Python loop over T (:215-248). The port keeps every
activation for the backward; the JAX package's remat (`remat_save_dots`)
saves memory only and changes no value.

Parameter names mirror the JAX param tree, so `params_from_jax` maps it
leaf by leaf: Dense `w` [in, out] -> `weight` [out, in], `b` -> `bias`,
LayerNorm `scale` / `bias` -> `weight` / `bias`, GRU `w_ih` / `w_hh` [D, 3H]
-> [3H, D] (torch's layout, as nn.GRUCell's). `params_to_jax` maps a
network back, reading each leaf's name from its module's type.

Init as `_mlp_init` / `_dense_init` / `_gru_init`: orthogonal weights with
gain sqrt(2) (5/3 for tanh) in the MLPs, `gain` for the mean head, 1 for the
value head; GRU weights and biases uniform(+-1/sqrt(H)); LayerNorm ones and
zeros; Linear biases zero. Every draw comes from the torch.Generator given
(a CPU generator: the same parameters on every device); the values differ
from JAX's threefry draws, so tests carry JAX parameters across instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from .rl_config import RLConfig
from .utils.distributions import DiagGaussian

ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
}


@dataclasses.dataclass(frozen=True)
class NetSpec:
    """Static network shape info derived from (RLConfig, obs_dim, act_dim)."""
    obs_dim: int
    act_dim: int
    hidden_sizes: Tuple[int, ...]
    act_hidden_sizes: Tuple[int, ...]
    activation: str
    use_feature_normalization: bool
    use_recurrent_policy: bool
    recurrent_hidden_size: int
    recurrent_hidden_layers: int
    gain: float
    min_log_std: float = -1e9

    @staticmethod
    def from_config(cfg: RLConfig, obs_dim: int, act_dim: int) -> "NetSpec":
        return NetSpec(
            obs_dim=obs_dim, act_dim=act_dim,
            hidden_sizes=tuple(cfg.hidden_sizes),
            act_hidden_sizes=tuple(cfg.act_hidden_sizes),
            activation=cfg.activation,
            use_feature_normalization=cfg.use_feature_normalization,
            use_recurrent_policy=cfg.use_recurrent_policy,
            recurrent_hidden_size=cfg.recurrent_hidden_size,
            recurrent_hidden_layers=cfg.recurrent_hidden_layers,
            gain=cfg.gain,
            min_log_std=(-1e9 if cfg.min_log_std is None
                         else float(cfg.min_log_std)),
        )

    @property
    def trunk_out(self) -> int:
        if self.use_recurrent_policy:
            return self.recurrent_hidden_size
        return self.hidden_sizes[-1] if self.hidden_sizes else self.obs_dim


# ---------------------------------------------------------------- init utils

def _dense(d_in: int, d_out: int) -> nn.Linear:
    """A Linear with its parameters allocated and not drawn (init_ draws)."""
    return skip_init(nn.Linear, d_in, d_out)


@torch.no_grad()
def _dense_init_(layer: nn.Linear, gain: float, g: torch.Generator) -> None:
    w = torch.empty(layer.weight.shape)
    layer.weight.copy_(nn.init.orthogonal_(w, gain=gain, generator=g))
    layer.bias.zero_()


# ------------------------------------------------------------------- modules

class MLPLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = _dense(d_in, d_out)
        self.ln = nn.LayerNorm(d_out, eps=1e-5)


class MLP(nn.Module):
    """[Linear -> act -> LayerNorm] per size (mlp.py:6-51)."""

    def __init__(self, d_in: int, sizes: Tuple[int, ...], activation: str):
        super().__init__()
        self.activation = activation
        self.layers = nn.ModuleList()
        for size in sizes:
            self.layers.append(MLPLayer(d_in, size))
            d_in = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        for layer in self.layers:
            x = layer.ln(act(layer.dense(x)))
        return x

    def init_(self, g: torch.Generator) -> None:
        gain = 5.0 / 3.0 if self.activation == "tanh" else math.sqrt(2.0)
        for layer in self.layers:
            _dense_init_(layer.dense, gain, g)
            layer.ln.reset_parameters()


class GRUCell(nn.Module):
    """One torch-convention GRU cell: gates (r, z, n), weights [3H, D]."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(3 * hidden, d_in))
        self.w_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.b_ih = nn.Parameter(torch.empty(3 * hidden))
        self.b_hh = nn.Parameter(torch.empty(3 * hidden))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = F.linear(x, self.w_ih, self.b_ih).chunk(3, dim=-1)
        h_r, h_z, h_n = F.linear(h, self.w_hh, self.b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.w_hh.shape[1])
        for p in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
            p.copy_(nn.init.uniform_(torch.empty(p.shape), -bound, bound, generator=g))


class GRU(nn.Module):
    """Stacked GRU cells and an output LayerNorm (gru.py:5-76)."""

    def __init__(self, d_in: int, hidden: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            GRUCell(d_in if i == 0 else hidden, hidden) for i in range(num_layers))
        self.ln = nn.LayerNorm(hidden, eps=1e-5)

    def step(self, x: torch.Tensor, h: torch.Tensor, mask: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One time step. x [N, D], h [N, layers, H], mask [N, 1]."""
        h = h * mask[:, None, :]   # zero hidden state at episode starts
        new_h = []
        for i, cell in enumerate(self.layers):
            x = cell(x, h[:, i])
            new_h.append(x)
        return self.ln(x), torch.stack(new_h, dim=1)

    def init_(self, g: torch.Generator) -> None:
        for cell in self.layers:
            cell.init_(g)
        self.ln.reset_parameters()


class Trunk(nn.Module):
    """Shared feature trunk of actor and critic."""

    def __init__(self, spec: NetSpec):
        super().__init__()
        self.spec = spec
        self.feature_norm = (nn.LayerNorm(spec.obs_dim, eps=1e-5)
                             if spec.use_feature_normalization else None)
        self.base = MLP(spec.obs_dim, spec.hidden_sizes, spec.activation)
        self.gru = None
        if spec.use_recurrent_policy:
            d_in = spec.hidden_sizes[-1] if spec.hidden_sizes else spec.obs_dim
            self.gru = GRU(d_in, spec.recurrent_hidden_size,
                           spec.recurrent_hidden_layers)

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs if self.feature_norm is None else self.feature_norm(obs)
        return self.base(x)

    def step(self, obs, h, mask):
        x = self.features(obs)
        if self.gru is not None:
            x, h = self.gru.step(x, h, mask)
        return x, h

    def seq(self, obs, h0, masks):
        """obs [T, N, D], h0 [N, layers, H], masks [T, N, 1]: the base MLP
        once over the whole block, then the GRU step by step."""
        x = self.features(obs)
        if self.gru is None:
            return x, h0
        h, ys = h0, []
        for t in range(x.shape[0]):
            y, h = self.gru.step(x[t], h, masks[t])
            ys.append(y)
        return torch.stack(ys), h

    def init_(self, g: torch.Generator) -> None:
        if self.feature_norm is not None:
            self.feature_norm.reset_parameters()
        self.base.init_(g)
        if self.gru is not None:
            self.gru.init_(g)


class _Net(nn.Module):
    """Trunk and optional head MLP, the part actor and critic share."""

    def __init__(self, spec: NetSpec):
        super().__init__()
        self.spec = spec
        self.trunk = Trunk(spec)
        self.act_mlp = (MLP(spec.trunk_out, spec.act_hidden_sizes, spec.activation)
                        if spec.act_hidden_sizes else None)

    @property
    def head_in(self) -> int:
        s = self.spec
        return s.act_hidden_sizes[-1] if s.act_hidden_sizes else s.trunk_out

    def head_features(self, feat: torch.Tensor) -> torch.Tensor:
        return feat if self.act_mlp is None else self.act_mlp(feat)

    def init_(self, g: torch.Generator) -> None:
        self.trunk.init_(g)
        if self.act_mlp is not None:
            self.act_mlp.init_(g)


class Actor(_Net):
    def __init__(self, spec: NetSpec, generator: torch.Generator):
        super().__init__(spec)
        self.mu = _dense(self.head_in, spec.act_dim)
        self.log_std = nn.Parameter(torch.zeros(spec.act_dim))
        self.init_(generator)

    def head(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = torch.tanh(self.mu(self.head_features(feat)))   # MuNet tanh squash
        # exploration floor (identity at the -1e9 default)
        return mean, torch.clamp_min(self.log_std, self.spec.min_log_std)

    def step(self, obs, h, mask):
        """Rollout-time forward. Returns (mean, log_std, new_h)."""
        feat, h = self.trunk.step(obs, h, mask)
        mean, log_std = self.head(feat)
        return mean, log_std, h

    def seq(self, obs, h0, masks):
        """Training-time chunk forward, obs [T, N, D]. Returns (mean, log_std, hT)."""
        feat, hT = self.trunk.seq(obs, h0, masks)
        mean, log_std = self.head(feat)
        return mean, log_std, hT

    def dist_step(self, obs, h, mask) -> Tuple[DiagGaussian, torch.Tensor]:
        """`step` as (distribution, new_h), the interface of every actor
        (algorithms/heads.py:HeadActor for the other action spaces)."""
        mean, log_std, h = self.step(obs, h, mask)
        return DiagGaussian(mean, log_std), h

    def dist_seq(self, obs, h0, masks) -> DiagGaussian:
        mean, log_std, _ = self.seq(obs, h0, masks)
        return DiagGaussian(mean, log_std)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        super().init_(g)
        _dense_init_(self.mu, self.spec.gain, g)
        self.log_std.zero_()


class Critic(_Net):
    def __init__(self, spec: NetSpec, generator: torch.Generator):
        super().__init__(spec)
        self.value = _dense(self.head_in, 1)
        self.init_(generator)

    def step(self, obs, h, mask):
        feat, h = self.trunk.step(obs, h, mask)
        return self.value(self.head_features(feat)), h

    def seq(self, obs, h0, masks):
        feat, hT = self.trunk.seq(obs, h0, masks)
        return self.value(self.head_features(feat)), hT

    def init_(self, g: torch.Generator) -> None:
        super().init_(g)
        _dense_init_(self.value, 1.0, g)


# the JAX package's function names: actor_step(actor, obs, h, mask), ...
actor_step, actor_seq = Actor.step, Actor.seq
critic_step, critic_seq = Critic.step, Critic.seq


def init_rnn_state(n: int, spec: NetSpec, device="cuda") -> torch.Tensor:
    return torch.zeros((n, spec.recurrent_hidden_layers, spec.recurrent_hidden_size),
                       dtype=torch.float32, device=device)


# ------------------------------------------------------- JAX parameters across

_TRANSPOSED = ("w", "w_ih", "w_hh")
_RENAMED = {"w": "weight", "b": "bias", "scale": "weight"}


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's param tree (nested dicts and lists of numpy arrays,
    e.g. {"actor": ..., "critic": ...} of policy.py:68-71, or one network's
    subtree) as a state_dict of the port's modules, float32 on the CPU:
    `policy.load_state_dict(params_from_jax(tree))`. Adam's moment trees have
    the same layout and map the same way."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            leaf = path[-1]
            a = np.asarray(node, dtype=np.float32)
            name = ".".join(path[:-1] + [_RENAMED.get(leaf, leaf)])
            # a copy: optimizer state loaded from it is updated in place
            out[name] = torch.tensor(a.T if leaf in _TRANSPOSED else a).contiguous()

    walk(tree, [])
    return out


def params_to_jax(module: nn.Module) -> dict:
    """The inverse of `params_from_jax` for one network: the module's
    parameters as the JAX package's param tree, nested dicts (keys sorted,
    as JAX pickles them) and lists (a ModuleList) of float32 numpy. The leaf
    names come from the owning module's type, not from the port's name,
    since `params_from_jax` maps both Dense `w` and LayerNorm `scale` to
    `weight`: a Linear's `weight` / `bias` become `w` [in, out] / `b`, a
    LayerNorm's become `scale` / `bias`, a GRU cell's `w_ih` / `w_hh` are
    transposed back to [D, 3H]; any other parameter keeps its name."""
    root: dict = {}
    for name, p in module.named_parameters():
        *owner_path, leaf = name.split(".")
        owner = module.get_submodule(".".join(owner_path))
        if isinstance(owner, nn.Linear):
            leaf = {"weight": "w", "bias": "b"}[leaf]
        elif isinstance(owner, nn.LayerNorm):
            leaf = {"weight": "scale", "bias": "bias"}[leaf]
        a = p.detach().to("cpu", torch.float32).numpy()
        a = np.ascontiguousarray(a.T if leaf in _TRANSPOSED else a)
        node = root
        for i, key in enumerate(owner_path):
            child = module.get_submodule(".".join(owner_path[:i + 1]))
            empty = [None] * len(child) if isinstance(child, nn.ModuleList) else {}
            if isinstance(node, list):
                if node[int(key)] is None:
                    node[int(key)] = empty
                node = node[int(key)]
            else:
                node = node.setdefault(key, empty)
        node[leaf] = a

    def sort(node):
        if isinstance(node, dict):
            return {k: sort(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [sort(v) for v in node]
        return node
    return sort(root)


def first_mismatch(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
                   ) -> Optional[str]:
    """The first leaf (in `want`'s order, then `got`'s extras) whose name or
    shape differs between two state_dicts, described; None if all agree."""
    for name, w in want.items():
        if name not in got:
            return f"{name}: missing (want shape {tuple(w.shape)})"
        if got[name].shape != w.shape:
            return (f"{name}: shape {tuple(got[name].shape)}, want "
                    f"{tuple(w.shape)}")
    extra = [n for n in got if n not in want]
    return f"{extra[0]}: not in this network" if extra else None

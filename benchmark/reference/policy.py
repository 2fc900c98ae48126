"""The recurrent actor-critic and its PPO update in plain PyTorch: the
reference the benchmark judges the program's policy forward and its first
optimizer steps against.

Networks (the NeuralPlane reference's PPO policy, as the configuration
sizes it): actor and critic each have an input LayerNorm, a base MLP of
[Linear -> ReLU -> LayerNorm] layers, stacked GRU cells (gates r, z, n)
whose state is multiplied by the step's mask, an output LayerNorm and a
head MLP; the actor's mean is tanh(Linear) beside a learnable log_std
(a diagonal Gaussian), the critic's value a Linear. The update: GAE,
advantages normalized over the whole rollout, recurrent chunks, per epoch a
permutation of the chunks cut into minibatches and sorted within each, the
clipped surrogate, 0.5 x the squared value error, the entropy bonus, actor
and critic gradients each clipped to a global norm, and Adam.

Precision: the configuration states float32 networks with TF32 off.
`precision="tf32"` rounds every operand of the networks' products, forward
and backward, to TF32's 10-bit mantissa instead: the control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)


# ------------------------------------------------------------ parameters

def param_spec(net: dict, obs_dim: int, act_dim: int) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every leaf, in the program's naming:
    init is ("normal", gain) for a dense weight (N(0, gain^2 / fan_in)),
    ("uniform", bound) for the GRU's weights and biases, ("ones",) or
    ("zeros",)."""
    hid, act_hid = tuple(net["hidden_sizes"]), tuple(net["act_hidden_sizes"])
    H, layers = int(net["recurrent_hidden_size"]), int(net["recurrent_hidden_layers"])
    relu_gain = math.sqrt(2.0)
    spec = []

    def dense(prefix, d_in, d_out, gain):
        spec.append((f"{prefix}.weight", (d_out, d_in), ("normal", gain)))
        spec.append((f"{prefix}.bias", (d_out,), ("zeros",)))

    def norm(prefix, d):
        spec.append((f"{prefix}.weight", (d,), ("ones",)))
        spec.append((f"{prefix}.bias", (d,), ("zeros",)))

    def mlp(prefix, d_in, sizes):
        for i, size in enumerate(sizes):
            dense(f"{prefix}.layers.{i}.dense", d_in, size, relu_gain)
            norm(f"{prefix}.layers.{i}.ln", size)
            d_in = size
        return d_in

    for name in ("actor", "critic"):
        norm(f"{name}.trunk.feature_norm", obs_dim)
        d = mlp(f"{name}.trunk.base", obs_dim, hid)
        for i in range(layers):
            d_in = d if i == 0 else H
            for leaf, shape in (("w_ih", (3 * H, d_in)), ("w_hh", (3 * H, H)),
                                ("b_ih", (3 * H,)), ("b_hh", (3 * H,))):
                spec.append((f"{name}.trunk.gru.layers.{i}.{leaf}", shape,
                             ("uniform", 1.0 / math.sqrt(H))))
        norm(f"{name}.trunk.gru.ln", H)
        d = mlp(f"{name}.act_mlp", H, act_hid)
        if name == "actor":
            dense("actor.mu", d, act_dim, float(net["gain"]))
            spec.append(("actor.log_std", (act_dim,), ("zeros",)))
        else:
            dense("critic.value", d, 1, 1.0)
    return spec


def make_params(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of `spec` from one generator on `device` seeded with
    `seed`, in two draws: one normal block for the dense weights, one
    uniform block for the GRU's."""
    g = torch.Generator(device=device).manual_seed(seed)
    size = {kind: sum(math.prod(s) for _, s, init in spec if init[0] == kind)
            for kind in ("normal", "uniform")}
    normal = torch.randn(size["normal"], generator=g, device=device)
    uniform = torch.rand(size["uniform"], generator=g, device=device) * 2.0 - 1.0
    out, used = {}, {"normal": 0, "uniform": 0}
    for name, shape, init in spec:
        kind, n = init[0], math.prod(shape)
        if kind == "normal":
            t = normal[used[kind]:used[kind] + n].view(shape) * (init[1] / math.sqrt(shape[1]))
        elif kind == "uniform":
            t = uniform[used[kind]:used[kind] + n].view(shape) * init[1]
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        used[kind] = used.get(kind, 0) + n
        out[name] = t.clone()
    return out


# -------------------------------------------------------------- products

def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W, b):
        xr, Wr = to_tf32(x), to_tf32(W)
        ctx.save_for_backward(xr, Wr)
        return F.linear(xr, Wr, b)

    @staticmethod
    def backward(ctx, g):
        xr, Wr = ctx.saved_tensors
        gr = to_tf32(g)
        gx = gr @ Wr
        gW = gr.reshape(-1, gr.shape[-1]).T @ xr.reshape(-1, xr.shape[-1])
        return gx, gW, g.reshape(-1, g.shape[-1]).sum(0)


def linear(x, W, b, precision: str):
    if precision == "float32":
        return F.linear(x, W, b)
    if precision == "tf32":
        return _TF32Linear.apply(x, W, b)
    raise ValueError(f"network precision must be float32 or tf32, got {precision!r}")


# --------------------------------------------------------------- forward

def _norm(p, prefix, x):
    return F.layer_norm(x, (x.shape[-1],), p[f"{prefix}.weight"], p[f"{prefix}.bias"], 1e-5)


def _mlp(p, prefix, x, sizes, precision):
    for i in range(len(sizes)):
        d = f"{prefix}.layers.{i}"
        x = _norm(p, f"{d}.ln", torch.relu(linear(x, p[f"{d}.dense.weight"],
                                                  p[f"{d}.dense.bias"], precision)))
    return x


def features(p, net: dict, name: str, obs, h0, masks, precision: str):
    """The head features [T, N, D] of actor or critic `name` over a chunk:
    obs [T, N, obs], h0 [N, layers, H], masks [T, N, 1] (the GRU state is
    multiplied by masks[t] before step t)."""
    x = _norm(p, f"{name}.trunk.feature_norm", obs)
    x = _mlp(p, f"{name}.trunk.base", x, net["hidden_sizes"], precision)
    layers = int(net["recurrent_hidden_layers"])
    h, ys = h0, []
    for t in range(x.shape[0]):
        h = h * masks[t][:, None, :]
        xt, new_h = x[t], []
        for i in range(layers):
            c = f"{name}.trunk.gru.layers.{i}"
            i_r, i_z, i_n = linear(xt, p[f"{c}.w_ih"], p[f"{c}.b_ih"], precision).chunk(3, -1)
            h_r, h_z, h_n = linear(h[:, i], p[f"{c}.w_hh"], p[f"{c}.b_hh"], precision).chunk(3, -1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            xt = (1.0 - z) * n + z * h[:, i]
            new_h.append(xt)
        h = torch.stack(new_h, dim=1)
        ys.append(_norm(p, f"{name}.trunk.gru.ln", xt))
    y = torch.stack(ys)
    return _mlp(p, f"{name}.act_mlp", y, net["act_hidden_sizes"], precision)


def evaluate(p, net, obs, h0_actor, h0_critic, actions, masks, precision: str):
    """(values, log-probs, entropy) [T, N, 1] of a chunk's actions."""
    fa = features(p, net, "actor", obs, h0_actor, masks, precision)
    mean = torch.tanh(linear(fa, p["actor.mu.weight"], p["actor.mu.bias"], precision))
    log_std = p["actor.log_std"].expand_as(mean)
    z = (actions - mean) * torch.exp(-log_std)
    logp = (-0.5 * (z * z + LOG_2PI) - log_std).sum(-1, keepdim=True)
    entropy = (0.5 * (1.0 + LOG_2PI) + log_std).sum(-1, keepdim=True)
    fc = features(p, net, "critic", obs, h0_critic, masks, precision)
    values = linear(fc, p["critic.value.weight"], p["critic.value.bias"], precision)
    return values, logp, entropy


# ---------------------------------------------------------------- update

def returns_and_advantages(rewards, values, masks, gamma: float, lam: float):
    """GAE returns [T, N, 1] and the advantages normalized over the whole
    rollout (population deviation, + 1e-5)."""
    T = rewards.shape[0]
    returns = torch.empty_like(rewards)
    gae = torch.zeros_like(rewards[0])
    for t in reversed(range(T)):
        delta = rewards[t] + gamma * values[t + 1] * masks[t + 1] - values[t]
        gae = delta + gamma * lam * masks[t + 1] * gae
        returns[t] = gae + values[t]
    adv = returns - values[:-1]
    mean = adv.sum() / adv.numel()
    std = (((adv - mean) ** 2).sum() / adv.numel()).sqrt()
    return returns, (adv - mean) / (std + 1e-5)


def to_chunks(x, L: int):
    """[T, N, ...] -> [N * T / L, L, ...]: each env's sequence cut into
    windows of L steps, env-major."""
    x = x.transpose(0, 1)
    return x.reshape(x.shape[0] * (x.shape[1] // L), L, *x.shape[2:])


def ppo_loss(p, net, upd: dict, mb, precision: str):
    obs, actions, masks, old_logp, adv, rets, h0a, h0c = mb
    values, logp, entropy = evaluate(p, net, obs, h0a, h0c, actions, masks, precision)
    ratio = torch.exp(logp - old_logp)
    clip = float(upd["clip_param"])
    surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
    policy_loss = -surr.mean()
    value_loss = 0.5 * ((rets - values) ** 2).mean()
    return (policy_loss + value_loss * float(upd["value_loss_coef"])
            - entropy.mean() * float(upd["entropy_coef"]))


def update_steps(p0: Dict[str, torch.Tensor], net: dict, upd: dict, batch: dict,
                 generator: torch.Generator, steps: int, precision: str = "float32",
                 half_batch: bool = False, m0=None, v0=None, step0: int = 0):
    """The first `steps` optimizer steps of the update from parameters p0 on
    a rollout `batch` (obs [T+1, N, D], actions, rewards, masks [T+1],
    action_log_probs, value_preds [T+1], h0_actor / h0_critic [T/L, N,
    layers, H]); each epoch's permutation of the chunks is drawn from
    `generator` (in the state the update found it) as the update draws it.
    Adam starts from the moments m0, v0 ({leaf: tensor}; None: zeros) after
    `step0` steps.

    Returns (losses [steps], gradients of step 1 as Adam gets them, the
    parameters after the last step). `half_batch` takes each minibatch's
    mean over its first half of rows only: a fault a check must see."""
    L = int(upd["data_chunk_length"])
    with torch.no_grad():
        rets, adv = returns_and_advantages(batch["rewards"], batch["value_preds"],
                                           batch["masks"], float(upd["gamma"]),
                                           float(upd["gae_lambda"]))

        def h0(h):
            return h.transpose(0, 1).reshape(-1, *h.shape[2:])
        ch = [to_chunks(batch["obs"][:-1], L), to_chunks(batch["actions"], L),
              to_chunks(batch["masks"][:-1], L), to_chunks(batch["action_log_probs"], L),
              to_chunks(adv, L), to_chunks(rets, L),
              h0(batch["h0_actor"]), h0(batch["h0_critic"])]
    n_chunks = ch[0].shape[0]
    n_mb = int(upd["num_mini_batch"])
    mb_size = n_chunks // n_mb
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    names = list(p)
    m = {k: (m0[k].clone() if m0 is not None else torch.zeros_like(v)) for k, v in p.items()}
    v2 = {k: (v0[k].clone() if v0 is not None else torch.zeros_like(v)) for k, v in p.items()}
    lr, eps = float(upd["lr"]), 1e-8
    losses, grad1 = [], None
    for k in range(steps):
        if k % n_mb == 0:
            perm = torch.randperm(n_chunks, generator=generator, device=generator.device)
            idx = perm[:mb_size * n_mb].reshape(n_mb, mb_size).sort(dim=1).values
        rows = idx[k % n_mb]
        if half_batch:
            rows = rows[:rows.numel() // 2]
        mb = [a.index_select(0, rows) for a in ch]
        mb = [a.transpose(0, 1) for a in mb[:-2]] + mb[-2:]
        loss = ppo_loss(p, net, upd, mb, precision)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        g = dict(zip(names, grads))
        with torch.no_grad():
            for net_name in ("actor", "critic"):
                leaves = [n for n in names if n.startswith(net_name + ".")]
                norm = torch.stack([g[n].pow(2).sum() for n in leaves]).sum().sqrt()
                scale = torch.clamp(float(upd["max_grad_norm"]) / (norm + 1e-12), max=1.0)
                for n in leaves:
                    g[n] = g[n] * scale
            if k == 0:
                grad1 = {n: g[n].clone() for n in names}
            t = step0 + k + 1
            bc1, bc2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
            for n in names:
                m[n] = 0.9 * m[n] + 0.1 * g[n]
                v2[n] = 0.999 * v2[n] + 0.001 * g[n] * g[n]
                denom = v2[n].sqrt() / math.sqrt(bc2) + eps
                p[n] -= (lr / bc1) * m[n] / denom
        losses.append(float(loss.detach()))
    return losses, grad1, {k: v.detach() for k, v in p.items()}

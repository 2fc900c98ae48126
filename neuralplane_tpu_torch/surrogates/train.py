"""Surrogate training: fit one MLP per aero coefficient table (counterpart
of neuralplane_tpu/surrogates/train.py).

The reference recipe: L1 loss, SGD lr 0.006 with momentum 0.9 and weight
decay 5e-4, the rate dropping to 5e-3 / 1e-3 / 5e-4 at epochs 500 / 750 /
900, batch 32, an 80/20 split, and the best model by test R^2 kept with a
0.97 acceptance gate. The JAX package chains add_decayed_weights(5e-4) before
sgd(1.0, momentum=0.9) and scales the update by the epoch's rate;
torch.optim.SGD(weight_decay=5e-4, momentum=0.9) with the group's lr set each
epoch is the same update. The epochs run eagerly on `device` (default the
card), the best parameters are kept on the device without a host read.

The split comes from numpy's generator seeded with `seed`, the epochs'
minibatch orders from a torch.Generator on the device, the initial weights
from a CPU generator: the port's own draws, not the JAX package's threefry
ones (its tests pass the same split, weights and orders to both).

`assemble_stacked_weights` pads the trained nets to the common
[3 -> 20 -> 20 -> 10 -> 1] architecture with the normalization folded in and
writes an `f16_aero.npz` that both packages' `load_aero_weights` read.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .tables import AeroTable, load_tables

HIDDEN = (20, 10)


def init_mlp(in_dim: int, hidden: Sequence[int] = HIDDEN,
             generator: torch.Generator = None) -> List[Dict[str, torch.Tensor]]:
    """Layers {"w": [in, out], "b": [out]}: w uniform(+-1/sqrt(in)), b zero,
    drawn from a CPU generator."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dims = [in_dim, *hidden, 1]
    layers = []
    for i in range(len(dims) - 1):
        bound = 1.0 / np.sqrt(dims[i])
        w = (torch.rand((dims[i], dims[i + 1]), generator=g) * 2.0 - 1.0) * float(bound)
        layers.append({"w": w, "b": torch.zeros(dims[i + 1])})
    return layers


def mlp_apply(params: List[Dict[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ params[-1]["w"] + params[-1]["b"]


def _r2(y: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    ss_res = ((y - pred) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    return 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)


def _lr_schedule(epoch: int) -> float:
    """0.006 -> 5e-3 @500 -> 1e-3 @750 -> 5e-4 @900."""
    return 6e-3 if epoch < 500 else 5e-3 if epoch < 750 else 1e-3 if epoch < 900 else 5e-4


def _leaves(params) -> List[torch.Tensor]:
    return [t for layer in params for t in (layer["w"], layer["b"])]


def make_optimizer(params) -> torch.optim.SGD:
    """The reference's SGD; the epoch's rate is set by run_epoch."""
    return torch.optim.SGD(_leaves(params), lr=_lr_schedule(0), momentum=0.9,
                           weight_decay=5e-4)


def run_epoch(params, optimizer: torch.optim.SGD, Xtr: torch.Tensor, Ytr: torch.Tensor,
              order: torch.Tensor, lr: float) -> None:
    """One epoch of L1 minibatch SGD over the rows of `order` [batches, batch]."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    for idx in order:
        optimizer.zero_grad(set_to_none=True)
        torch.abs(mlp_apply(params, Xtr[idx]) - Ytr[idx]).mean().backward()
        optimizer.step()


def train_surrogate(table: AeroTable, seed: int = 0, epochs: int = 1000,
                    batch_size: int = 32, subdivide: int = 3, r2_gate: float = 0.97,
                    hidden: Sequence[int] = HIDDEN, device="cuda") -> Dict:
    """Train one surrogate; returns a dict with params (on z-scored inputs
    and outputs, as numpy), normalization stats and the best test R^2."""
    dev = torch.device(device)
    points, targets = table.dense_grid(subdivide)
    x_mean, x_std = points.mean(0), points.std(0) + 1e-12
    y_mean, y_std = targets.mean(), targets.std() + 1e-12
    X = ((points - x_mean) / x_std).astype(np.float32)
    Y = (((targets - y_mean) / y_std)[:, None]).astype(np.float32)

    # 80/20 shuffled split
    perm = np.random.default_rng(seed).permutation(len(X))
    n_test = max(1, len(X) // 5)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    Xtr, Ytr = (torch.from_numpy(a[train_idx]).to(dev) for a in (X, Y))
    Xte, Yte = (torch.from_numpy(a[test_idx]).to(dev) for a in (X, Y))

    n_train = len(train_idx)
    # a table with fewer training points than a batch (eta_el: 5 grid points,
    # 11 training points at subdivide 3) trains in one smaller batch; the
    # JAX package's reshape to a whole batch fails there
    batch_size = min(batch_size, n_train)
    n_batches = n_train // batch_size
    used = n_batches * batch_size

    params = [{k: v.to(dev).requires_grad_() for k, v in layer.items()}
              for layer in init_mlp(X.shape[1], hidden, torch.Generator().manual_seed(seed))]
    optimizer = make_optimizer(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    best = [t.detach().clone() for t in _leaves(params)]
    best_r2 = torch.tensor(float("-inf"), device=dev)
    for epoch in range(epochs):
        order = torch.randperm(n_train, generator=gen, device=dev)[:used]
        run_epoch(params, optimizer, Xtr, Ytr, order.reshape(n_batches, batch_size),
                  _lr_schedule(epoch))
        with torch.no_grad():
            test_r2 = _r2(Yte, mlp_apply(params, Xte))
            better = test_r2 > best_r2
            for b, t in zip(best, _leaves(params)):
                b.copy_(torch.where(better, t, b))
            best_r2 = torch.maximum(best_r2, test_r2)

    best = [t.cpu().numpy() for t in best]
    best_r2 = float(best_r2)
    return {
        "name": table.name,
        "params": [{"w": best[2 * i], "b": best[2 * i + 1]} for i in range(len(params))],
        "input_keys": table.input_keys,
        "x_mean": x_mean, "x_std": x_std,
        "y_mean": float(y_mean), "y_std": float(y_std),
        "test_r2": best_r2, "passed": best_r2 > r2_gate,
    }


def train_all(data_dir: str, names: Sequence[str] = None, seed: int = 0,
              **kwargs) -> Dict[str, Dict]:
    tables = load_tables(data_dir, names)
    out = {}
    for i, (name, table) in enumerate(tables.items()):
        out[name] = train_surrogate(table, seed + i, **kwargs)
        print(f"{name}: test R^2 = {out[name]['test_r2']:.4f} "
              f"({'PASS' if out[name]['passed'] else 'FAIL'})")
    return out


# ---------------------------------------------------------------- stacking

H1, H2, H3 = 20, 20, 10


def _pad_layers(result: Dict) -> Tuple[np.ndarray, ...]:
    """Pad one trained net to [3 -> H1 -> H2 -> H3 -> 1] with z-scoring
    folded into layers 1/4 (same exact-padding scheme as
    tools/convert_aero_weights.py: zero input columns for missing raw
    inputs, identity hidden layer insertion, zero-padded widths)."""
    params = result["params"]
    keys = result["input_keys"]
    x_mean, x_std = np.asarray(result["x_mean"]), np.asarray(result["x_std"])
    y_mean, y_std = result["y_mean"], result["y_std"]
    col_of = {"alpha": 0, "beta": 1, "el": 2}

    # layer 1 with normalization fold: z = (raw - mu) / sigma
    w1 = np.asarray(params[0]["w"])  # [in, h1]
    b1 = np.asarray(params[0]["b"])
    W1 = np.zeros((3, H1), np.float64)
    b1_f = b1.astype(np.float64).copy()
    for i, k in enumerate(keys):
        W1[col_of[k], :w1.shape[1]] = w1[i] / x_std[i]
        b1_f[:w1.shape[1]] -= w1[i] * x_mean[i] / x_std[i]
    B1 = np.zeros(H1); B1[:len(b1_f)] = b1_f

    if len(params) == 3:  # [in,20,10,1]: insert identity layer 2
        W2 = np.zeros((H1, H2)); np.fill_diagonal(W2, 1.0)
        B2 = np.zeros(H2)
        w3, b3 = np.asarray(params[1]["w"]), np.asarray(params[1]["b"])
        wo, bo = np.asarray(params[2]["w"]), np.asarray(params[2]["b"])
    else:  # [in,20,20,10,1]
        w2, b2 = np.asarray(params[1]["w"]), np.asarray(params[1]["b"])
        W2 = np.zeros((H1, H2)); W2[:w2.shape[0], :w2.shape[1]] = w2
        B2 = np.zeros(H2); B2[:len(b2)] = b2
        w3, b3 = np.asarray(params[2]["w"]), np.asarray(params[2]["b"])
        wo, bo = np.asarray(params[3]["w"]), np.asarray(params[3]["b"])

    W3 = np.zeros((H2, H3)); W3[:w3.shape[0], :w3.shape[1]] = w3
    B3 = np.zeros(H3); B3[:len(b3)] = b3
    # output layer with un-scaling fold: y = z * y_std + y_mean
    W4 = np.zeros(H3); W4[:wo.shape[0]] = wo[:, 0] * y_std
    B4 = float(bo[0]) * y_std + y_mean
    return W1, B1, W2, B2, W3, B3, W4, B4


def assemble_stacked_weights(results: Dict[str, Dict], out_path: str) -> None:
    """Write an f16_aero.npz in ops.aero's stacked AeroWeights layout."""
    from ..ops.aero import AERO_NAMES
    stacks = {k: [] for k in ("W1", "b1", "W2", "b2", "W3", "b3", "W4", "b4")}
    for name in AERO_NAMES:
        W1, B1, W2, B2, W3, B3, W4, B4 = _pad_layers(results[name])
        for k, v in zip(stacks, (W1, B1, W2, B2, W3, B3, W4, B4)):
            stacks[k].append(v)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, names=np.array(AERO_NAMES),
             **{k: np.stack(v).astype(np.float32) for k, v in stacks.items()})

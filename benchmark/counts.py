"""The yardstick's arithmetic: the H100's peaks and the operations and
bytes that a configuration's work needs, counted from the widths its file
states (never from what a kernel happens to multiply).

Peaks: one H100 SXM, NVIDIA's data sheet, dense, at the 700 W limit.
"""
from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# bytes of one aircraft's step as the step kernel's interface has them:
# read sf 12, uf 5, action 4, targets 3 (float32), step count (int32),
# mask (bool); written sf 12, uf 5, obs 22, reward 1, targets 3 (float32),
# done, bad (bool)
STEP_READ_BYTES = 4 * (12 + 5 + 4 + 3 + 1) + 1
STEP_WRITE_BYTES = 4 * (12 + 5 + 22 + 1 + 3) + 2


def surrogate_flops(surrogate: dict) -> float:
    """Multiply-adds x 2 of the aero surrogate per aircraft.

    "nets43": one net [3 -> 20 -> 20 -> 10 -> 1] per coefficient.
    "distilled": 68 features -> H -> H, and a readout of the 43 real
    coefficients over [hidden ; features]."""
    if surrogate["kind"] == "nets43":
        w = surrogate["widths"]
        return float(surrogate["nets"] * 2 * sum(a * b for a, b in zip(w[:-1], w[1:])))
    if surrogate["kind"] == "distilled":
        F, H, K = surrogate["features"], surrogate["hidden"], surrogate["outputs"]
        return 2.0 * (H * F + H * H + K * (H + F))
    raise ValueError(f"unknown surrogate kind {surrogate['kind']!r}")


def surrogate_weight_bytes(surrogate: dict) -> int:
    """The surrogate's weights once: bf16 matrices, float32 vectors."""
    if surrogate["kind"] == "nets43":
        w = surrogate["widths"]
        mats = sum(a * b for a, b in zip(w[:-1], w[1:]))
        vecs = sum(w[1:])
        return surrogate["nets"] * (2 * mats + 4 * vecs)
    F, H, K = surrogate["features"], surrogate["hidden"], surrogate["outputs"]
    return 2 * (H * F + H * H + K * (H + F)) + 4 * (2 * H + 3 * K)


def env_step_bound_s(surrogate: dict, aircraft: int) -> float:
    """The least time one env step of `aircraft` can take on the card: the
    larger of the surrogate's operations at the bf16 peak and the step's
    bytes (each input read once, each output written once, plus the
    weights) at the memory's peak."""
    t_ops = surrogate_flops(surrogate) * aircraft / PEAK_FLOPS[surrogate["precision"]]
    nbytes = (STEP_READ_BYTES + STEP_WRITE_BYTES) * aircraft + surrogate_weight_bytes(surrogate)
    return max(t_ops, nbytes / PEAK_BYTES)


def network_flops(net: dict, obs_dim: int, act_dim: int) -> dict:
    """Multiply-adds x 2 of one forward of actor and critic for one sample
    (a rollout step or one step of a training chunk): the dense layers and
    the GRU's two products per layer."""
    H, layers = net["recurrent_hidden_size"], net["recurrent_hidden_layers"]

    def mlp(d, sizes):
        total = 0
        for s in sizes:
            total += d * s
            d = s
        return total, d

    def one(head):
        base, d = mlp(obs_dim, net["hidden_sizes"])
        gru = sum(3 * H * ((d if i == 0 else H) + H) for i in range(layers))
        act, d = mlp(H, net["act_hidden_sizes"])
        return 2 * (base + gru + act + d * head)
    return {"actor": float(one(act_dim)), "critic": float(one(1))}


def train_iteration_flops(cfg: dict, obs_dim: int, act_dim: int) -> dict:
    """Operations of one PPO iteration, by the precision they run in: the
    surrogate once per aircraft-step of the collect; the networks' forward
    once per collected sample (and the bootstrap value), and forward plus
    backward (3 x forward) per sample of every minibatch of every epoch."""
    n, T, L = cfg["n_rollout_threads"], cfg["buffer_size"], cfg["data_chunk_length"]
    f = network_flops(cfg["networks"], obs_dim, act_dim)
    fwd = f["actor"] + f["critic"]
    chunks = n * T // L
    used = (chunks // cfg["num_mini_batch"]) * cfg["num_mini_batch"]
    samples = cfg["ppo_epoch"] * used * L
    out: dict = {}
    parts = ((cfg["surrogate"]["precision"], surrogate_flops(cfg["surrogate"]) * n * T),
             (cfg["precision"]["networks"], fwd * n * T + f["critic"] * n + 3.0 * fwd * samples))
    for precision, flops in parts:
        out[precision] = out.get(precision, 0.0) + flops
    return out


def peak_seconds(flops_by_precision: dict) -> float:
    """Seconds the card would need at its peak for each precision's share."""
    return sum(v / PEAK_FLOPS[k] for k, v in flops_by_precision.items())

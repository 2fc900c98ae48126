"""Trajectory recording, evaluation metrics and plotting (counterpart of
neuralplane_tpu/render/trajectory.py).

  - TrajectoryRecorder: the 15 state/control channel buffers (plus the
    task's targets) the render CLI accumulates and np.save's;
  - model_channels: those channels' batch means as one device tensor, so a
    frame costs one device-to-host copy;
  - evaluate_metrics: maneuverability (mean |G|, TAS, rate of climb, |AOA|)
    and safety margins (altitude/speed/overload/AOA/sideslip);
  - plot_result: the time-series figure; matplotlib is imported inside it
    only, and an ImportError reaches the caller.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

FT = 0.3048
R2D = 180.0 / math.pi
G_LIMIT = 300.0 / 32.17  # overload envelope in g


def model_channels(model, mstate, xdot: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The CHANNELS of TrajectoryRecorder from the model interface, each the
    batch mean as a 0-d tensor on the state's device."""
    npos, epos, altitude = model.get_position(mstate)
    roll, pitch, yaw = model.get_posture(mstate)
    el, ail, rud, _ = model.get_control_surface(mstate)
    T = model.get_thrust(mstate)
    ch = dict(npos=npos, epos=epos, altitude=altitude, roll=roll, pitch=pitch, yaw=yaw,
              vt=model.get_vt(mstate), alpha=model.get_AOA(mstate),
              beta=model.get_AOS(mstate), G=model.get_G(mstate, xdot), T=T,
              throttle=T * 0.3048 / 82339.0 / 0.225, ail=ail, el=el, rud=rud)
    return {k: v.float().mean() for k, v in ch.items()}


class TrajectoryRecorder:
    """Accumulates per-step batch-mean channels; save() writes result/*.npy."""

    CHANNELS = ["npos", "epos", "altitude", "roll", "pitch", "yaw", "vt",
                "alpha", "beta", "G", "T", "throttle", "ail", "el", "rud"]

    def __init__(self):
        self.buffers: Dict[str, List[float]] = {}

    def record(self, **channels: float) -> None:
        for name, value in channels.items():
            self.buffers.setdefault(name, []).append(float(np.mean(value)))

    def record_model(self, model, mstate, xdot) -> None:
        """Record the standard channel set from the model interface (one
        device-to-host copy)."""
        ch = model_channels(model, mstate, xdot)
        self.record(**dict(zip(ch, torch.stack(list(ch.values())).cpu().tolist())))

    def arrays(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self.buffers.items()}

    def save(self, result_dir: str) -> None:
        os.makedirs(result_dir, exist_ok=True)
        for name, buf in self.arrays().items():
            np.save(os.path.join(result_dir, f"{name}.npy"), buf)


def evaluate_metrics(buffers: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Maneuverability + safety-margin metrics
    (`renders/evaluate_result.py:31-53`, normalizations preserved)."""
    alt = buffers["altitude"]
    vt = buffers["vt"]
    pitch = buffers["pitch"]
    alpha = buffers["alpha"]
    beta = buffers["beta"]
    G = buffers["G"]
    return {
        # maneuverability
        "mean_G": float(np.mean(np.abs(G)) / G_LIMIT),
        "mean_TAS": float(np.mean(vt) * FT / 340.0),
        "mean_RoC": float(np.mean(np.abs(vt * np.sin(pitch))) * FT / 100.0),
        "mean_AOA": float(np.mean(np.abs(alpha)) * R2D / 32.5),
        # safety margins
        "ASM": float(np.mean(alt - 2500.0) * FT / 5000.0),
        "SSM": float(np.mean(1.505 - np.abs(vt * FT / 340.0 - 1.505)) / 1.505),
        "OSM": float(np.mean(G_LIMIT - np.abs(G)) / G_LIMIT),
        "AOASM": float(np.mean(32.5 - np.abs(alpha * R2D - 12.5)) / 32.5),
        "AOSSM": float(np.mean(30.0 - np.abs(beta) * R2D) / 30.0),
    }


def plot_result(buffers: Dict[str, np.ndarray], out_path: str,
                dt: float = 0.02) -> None:
    """Time-series overview figure (`renders/plot_result.py`)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = [
        ("altitude [ft]", ["altitude", "target_altitude"]),
        ("attitude [rad]", ["roll", "pitch", "yaw", "target_heading",
                            "target_pitch"]),
        ("speed [ft/s]", ["vt", "target_vt"]),
        ("aero angles [rad]", ["alpha", "beta"]),
        ("load factor [g]", ["G"]),
        ("controls", ["throttle", "el", "ail", "rud"]),
    ]
    rows = [g for g in groups if any(k in buffers for k in g[1])]
    fig, axes = plt.subplots(len(rows), 1, figsize=(10, 2.2 * len(rows)),
                             sharex=True)
    if len(rows) == 1:
        axes = [axes]
    for ax, (label, keys) in zip(axes, rows):
        for k in keys:
            if k in buffers:
                t = np.arange(len(buffers[k])) * dt
                ax.plot(t, buffers[k], label=k,
                        linestyle="--" if k.startswith("target") else "-")
        ax.set_ylabel(label)
        ax.legend(loc="upper right", fontsize=7)
    axes[-1].set_xlabel("time [s]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)

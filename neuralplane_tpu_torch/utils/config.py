"""Typed scenario configuration (counterpart of neuralplane_tpu/utils/config.py).

The port keeps its own copy of the dataclasses and of the scenario YAMLs
(`neuralplane_tpu_torch/configs/*.yaml`, byte for byte the JAX package's).
Field meanings are documented on the JAX side; the defaults here are the
same.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional

import yaml

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs")


@dataclasses.dataclass(frozen=True)
class InitState:
    init_altitude_ft: float = 20000.0
    init_heading: float = 0.0
    init_vt_ft: float = 1100.0
    init_T: float = 2000.0


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Scenario configuration (sim + aircraft + task + init ranges)."""

    # atmos
    airspeed: float = 0.0
    noise_scale: float = 0.01

    # simulation
    sim_freq: int = 60
    solver: str = "euler"          # euler | rk4
    dt: float = 0.02
    num_agents: int = 1
    num_states: int = 12
    num_controls: int = 5
    num_actions: int = 4
    num_observation: int = 22
    max_steps: int = 2500

    # aircraft limits
    altitude_limit: float = 2500.0
    acceleration_limit: float = 300.0
    max_velocity: float = 3.0      # Mach
    min_velocity: float = 0.01     # Mach
    min_alpha: float = -20.0       # deg
    max_alpha: float = 45.0        # deg
    min_beta: float = -30.0        # deg
    max_beta: float = 30.0         # deg
    color: str = "Red"
    model: str = "f16"

    # target sampling
    max_heading_increment: float = 0.3     # rad
    max_pitch_increment: float = 0.3       # rad
    max_altitude_increment: float = 500.0  # ft
    max_velocities_u_increment: float = 100.0  # ft/s
    max_distance: float = 2000.0   # ft (tracking)
    min_distance: float = 2000.0   # ft
    max_check_interval: int = 2500
    min_check_interval: int = 300

    # init ranges
    init_state: InitState = dataclasses.field(default_factory=InitState)
    max_altitude: float = 20000.0
    min_altitude: float = 19000.0
    max_vt: float = 1200.0
    min_vt: float = 1000.0

    # combat (selfplay scenarios; read by later slices of the port)
    preset_name: str = "F16"
    ego_agents: int = 1
    enm_agents: int = 1
    max_blood: float = 100.0
    distance_limit: float = 200.0
    init_T: float = 2000.0
    target_dist: float = 3.0
    max_heading: float = 0.5
    min_heading: float = -0.5
    max_npos: float = 5000.0
    min_npos: float = -5000.0
    max_epos: float = 5000.0
    symmetric_side_flag: bool = False
    min_epos: float = -5000.0

    # shoot-combat (missile) scenarios
    max_missiles: int = 4
    missile_speed: float = 2000.0
    missile_g_max: float = 12.0
    missile_duration: float = 20.0
    missile_hit_radius: float = 200.0
    missile_damage: float = 100.0
    missile_cooldown: float = 4.0
    missile_nav_gain: float = 3.0
    missile_shoot_cost: float = 5.0
    wez_max_ao_deg: float = 60.0
    wez_max_range: float = 20000.0
    missile_fuse_outer: float = 0.0
    missile_threat_obs: bool = False
    blood_shaping: float = 0.0
    attitude_bins: int = 41
    throttle_bins: int = 30

    # hierarchical control (planning env)
    low_level_steps: int = 50
    low_level_ckpt: Optional[str] = None

    # reuse the integrator's step-start xdot for the termination checks
    reuse_step_xdot: bool = True
    # run the whole step as one kernel (ops/step_cuda.py)
    fused_task_kernel: bool = True
    # draw the sensor noise inside the step kernel (Philox + Box-Muller)
    kernel_obs_noise: bool = True
    # draw the reset uniforms and the target resample inside the step kernel
    kernel_reset_draws: bool = True
    # random (vs the reference's fixed) heading-task target increments
    heading_random_increments: bool = False

    def replace(self, **kwargs: Any) -> "EnvConfig":
        return dataclasses.replace(self, **kwargs)


def load_config(name_or_path: str, **overrides: Any) -> EnvConfig:
    """Load a scenario config by name (from the JAX package's configs/) or path."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_CONFIG_DIR, f"{name_or_path}.yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"No scenario config: {name_or_path!r} (looked in {_CONFIG_DIR})")
    with open(path, "r", encoding="utf-8") as f:
        raw: Mapping[str, Any] = yaml.safe_load(f) or {}
    return config_from_dict({**raw, **overrides})


def config_from_dict(raw: Mapping[str, Any]) -> EnvConfig:
    field_names = {f.name for f in dataclasses.fields(EnvConfig)}
    known = {k: v for k, v in raw.items() if k in field_names}
    unknown = sorted(set(raw) - field_names)
    if unknown:
        raise KeyError(f"Unknown scenario config keys: {unknown}")
    if "init_state" in known and isinstance(known["init_state"], Mapping):
        known["init_state"] = InitState(**known["init_state"])
    return EnvConfig(**known)

"""Controller gain configurations (counterpart of
neuralplane_tpu/algorithms/pid/config.py).

Frozen dataclasses of plain Python floats with the JAX package's values
(the reference's YAML gain files: roll/pitch/yaw/speed controller, TECS,
L1). Branches on a gain are Python-level, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PIDGains:
    """Batched PID gains (reference `pid.py:6-16`)."""
    Kp: float = 0.0
    Ki: float = 0.0
    Kd: float = 0.0
    Kff: float = 0.0
    Kimax: float = 0.0
    dt: float = 0.01


@dataclasses.dataclass(frozen=True)
class RateControllerConfig:
    """Roll/pitch/yaw rate-loop config (config/{roll,pitch,yaw}controller.yaml)."""
    gains: PIDGains = PIDGains(Kp=10.0, Ki=0.3, Kd=0.0, Kff=0.3, Kimax=0.666)
    tau: float = 0.5
    rmax_pos: float = 0.0
    rmax_neg: float = 0.0
    roll_ff: float = 1.0
    gravity: float = 32.174

    @staticmethod
    def roll(dt: float = 0.02) -> "RateControllerConfig":
        return RateControllerConfig(gains=PIDGains(10.0, 0.3, 0.0, 0.3, 0.666, dt))

    @staticmethod
    def pitch(dt: float = 0.02) -> "RateControllerConfig":
        return RateControllerConfig(gains=PIDGains(10.0, 0.3, 0.0, 0.3, 0.666, dt))

    @staticmethod
    def yaw(dt: float = 0.02) -> "RateControllerConfig":
        return RateControllerConfig(
            gains=PIDGains(1.0, 0.3, 0.05, 0.3, 0.666, dt), tau=0.2)


@dataclasses.dataclass(frozen=True)
class YawDamperConfig:
    """Legacy sideslip-damper gains (config/yawcontroller.yaml KA/KI/KD/KFF/
    imax block; the reference ships them all zero, i.e. damper off)."""
    gains: PIDGains = PIDGains(Kp=1.0, Ki=0.3, Kd=0.05, Kff=0.3,
                               Kimax=0.666, dt=0.02)
    KA: float = 0.0
    KI: float = 0.0
    KD: float = 0.0
    KFF: float = 1.0
    imax: float = 1500.0
    gravity: float = 32.174


@dataclasses.dataclass(frozen=True)
class SpeedControllerConfig:
    """Throttle-from-accel PID (config/speedcontroller.yaml). The reference's
    SpeedController references a never-assigned `rate_pid` (C8 bit-rot,
    `speedController.py:27`); this implementation wires it correctly."""
    gains: PIDGains = PIDGains(Kp=5.0, Ki=25.0, Kd=0.0, Kff=80.0, Kimax=100.0)


@dataclasses.dataclass(frozen=True)
class TECSConfig:
    """Total-energy controller parameters (config/tecs.yaml; ft units after
    the /0.3048 conversions at `TECS.py:33-36,41`)."""
    maxClimbRate: float = 254.0 / 0.3048
    minSinkRate: float = 2.0 / 0.3048
    maxSinkRate: float = 254.0 / 0.3048
    timeConst: float = 5.0
    thrDamp: float = 0.5
    integGain: float = 0.1
    vertAccLim: float = 20.0 / 0.3048
    hgtCompFiltOmega: float = 3.0
    spdCompFiltOmega: float = 2.0
    rollComp: float = 10.0
    spdWeight: float = 1.0
    pitchDamp: float = 0.3
    pitch_max: float = 15.0 * math.pi / 180.0
    pitch_min: float = -15.0 * math.pi / 180.0
    throttle_cruise: float = 4.0
    THR_max: float = 100.0 * 0.01
    THR_min: float = -100.0 * 0.01
    gravity: float = 32.174
    hgt_dem_tconst: float = 5.0
    airspeed_min: float = 100.0
    airspeed_max: float = 2300.0
    dt: float = 0.1


@dataclasses.dataclass(frozen=True)
class L1Config:
    """L1 lateral navigation (config/l1controller.yaml)."""
    L1_period: float = 17.0
    L1_damping: float = 0.75
    L1_xtrack_i_gain: float = 0.02
    loiter_bank_limit: float = 0.0
    gravity: float = 32.174
    dt: float = 0.1


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Facade config (reference `controller.py:15-28`)."""
    airspeed_min: float = 100.0
    airspeed_max: float = 2300.0
    dt: float = 0.02
    gravity: float = 32.174
    roll_limit: float = math.pi / 4
    roll: RateControllerConfig = RateControllerConfig.roll()
    pitch: RateControllerConfig = RateControllerConfig.pitch()
    yaw: RateControllerConfig = RateControllerConfig.yaw()
    tecs: TECSConfig = TECSConfig(dt=0.1)
    l1: L1Config = L1Config(dt=0.1)

    @staticmethod
    def make(dt: float = 0.02, airspeed_min: float = 100.0,
             airspeed_max: float = 2300.0) -> "ControllerConfig":
        # TECS/L1 run at 5*dt (reference controller.py:19-20)
        return ControllerConfig(
            airspeed_min=airspeed_min, airspeed_max=airspeed_max, dt=dt,
            roll=RateControllerConfig.roll(dt), pitch=RateControllerConfig.pitch(dt),
            yaw=RateControllerConfig.yaw(dt),
            tecs=TECSConfig(dt=5 * dt, airspeed_min=airspeed_min,
                            airspeed_max=airspeed_max),
            l1=L1Config(dt=5 * dt))

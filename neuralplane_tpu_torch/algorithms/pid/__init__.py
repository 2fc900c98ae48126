"""Classical controllers (counterpart of neuralplane_tpu/algorithms/pid)."""
from .config import (PIDGains, RateControllerConfig, TECSConfig, L1Config,
                     ControllerConfig, SpeedControllerConfig, YawDamperConfig)
from .pid import PIDState, pid_init, pid_update_all
from .attitude import (RateState, rate_init, roll_servo_out, pitch_servo_out,
                       yaw_rate_out, YawDamperState, yaw_damper_init,
                       yaw_servo_out)
from .speed import SpeedState, speed_init, speed_throttle_out
from .tecs import TECSState, tecs_init, tecs_update_pitch_throttle
from .l1 import (L1State, l1_init, l1_update_waypoint, l1_update_loiter,
                 l1_update_heading_hold, l1_update_level_flight, l1_nav_roll)
from .controller import Controller, ControllerState, FlightData, flight_data

__all__ = [
    "PIDGains", "RateControllerConfig", "TECSConfig", "L1Config",
    "ControllerConfig", "SpeedControllerConfig",
    "SpeedState", "speed_init", "speed_throttle_out", "PIDState", "pid_init", "pid_update_all",
    "RateState", "rate_init", "roll_servo_out", "pitch_servo_out",
    "yaw_rate_out", "YawDamperConfig", "YawDamperState", "yaw_damper_init",
    "yaw_servo_out",
    "TECSState", "tecs_init", "tecs_update_pitch_throttle",
    "L1State", "l1_init", "l1_update_waypoint", "l1_update_loiter",
    "l1_update_heading_hold", "l1_update_level_flight", "l1_nav_roll",
    "Controller", "ControllerState", "FlightData", "flight_data",
]

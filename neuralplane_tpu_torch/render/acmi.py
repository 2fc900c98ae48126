"""ACMI (TacView) flight recording (counterpart of
neuralplane_tpu/render/acmi.py).

text/acmi/tacview 2.0 header, per-frame `#<t>` timestamps, and one
`id,T=lon|lat|alt|roll|pitch|yaw,Name=...,Color=...` line per aircraft, with
ENU-feet states converted to geodetic degrees/meters about the (0, 0, 0)
reference origin; extra objects (missiles) with `Type=...` on the current
frame and `-id` destruction lines. A standalone host-side writer: the render
CLI pulls a frame's states to the host once and feeds them here. The same
states give the same bytes as the JAX package's writer.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..utils.geodesy import enu_to_geodetic

FT = 0.3048
R2D = 180.0 / math.pi


class ACMIWriter:
    def __init__(self, filepath: str,
                 reference_time: str = "2023-04-01T00:00:00Z"):
        self.filepath = filepath
        with open(filepath, "w", encoding="utf-8") as f:
            f.write("FileType=text/acmi/tacview\n")
            f.write("FileVersion=2.0\n")
            f.write(f"0,ReferenceTime={reference_time}\n")

    def write_frame(self, timestamp: float, states: np.ndarray,
                    names: Optional[Sequence[str]] = None,
                    colors: Optional[Sequence[str]] = None,
                    base_id: int = 100) -> None:
        """Append one frame. states: [n, >=6] rows of
        (npos_ft, epos_ft, alt_ft, roll, pitch, yaw)."""
        states = np.asarray(states)
        n = states.shape[0]
        names = names or ["F16"] * n
        colors = colors or ["Red"] * n
        with open(self.filepath, "a", encoding="utf-8") as f:
            f.write(f"#{timestamp:.2f}\n")
            for i in range(n):
                npos, epos, alt = states[i, 0] * FT, states[i, 1] * FT, \
                    states[i, 2] * FT
                lat, lon, alt_m = enu_to_geodetic(epos, npos, alt, 0.0, 0.0,
                                                  0.0)
                roll, pitch, yaw = (states[i, 3] * R2D, states[i, 4] * R2D,
                                    states[i, 5] * R2D)
                f.write(f"{base_id + i},T={float(lon)}|{float(lat)}|"
                        f"{float(alt_m)}|{float(roll)}|{float(pitch)}|"
                        f"{float(yaw)},Name={names[i]},Color={colors[i]}\n")

    def write_object(self, obj_id: int, state: np.ndarray, name: str,
                     color: str, obj_type: str = "Missile") -> None:
        """Append one extra object line to the CURRENT frame (call after
        write_frame; ACMI lines following a `#t` timestamp belong to it).
        state: (npos_ft, epos_ft, alt_ft, roll, pitch, yaw)."""
        npos, epos, alt = (float(state[0]) * FT, float(state[1]) * FT,
                           float(state[2]) * FT)
        lat, lon, alt_m = enu_to_geodetic(epos, npos, alt, 0.0, 0.0, 0.0)
        roll, pitch, yaw = (float(state[3]) * R2D, float(state[4]) * R2D,
                            float(state[5]) * R2D)
        with open(self.filepath, "a", encoding="utf-8") as f:
            f.write(f"{obj_id},T={float(lon)}|{float(lat)}|{float(alt_m)}|"
                    f"{roll}|{pitch}|{yaw},Name={name},Color={color},"
                    f"Type={obj_type}\n")

    def remove_object(self, obj_id: int) -> None:
        """TacView object-destruction event (`-id` line)."""
        with open(self.filepath, "a", encoding="utf-8") as f:
            f.write(f"-{obj_id}\n")

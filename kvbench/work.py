"""The yardstick of a step's work and the table of device peaks.

`step_bytes` counts what any implementation of a conflict step must move
at least, from shapes and the live boundary count read from the state:
the live state (L key limbs and one version per boundary, 4 bytes each)
read once and written once, the packed batch read once and the readback
row written once. It reads the same whatever kernels implement the step.
"""

from __future__ import annotations

# published peaks (NVIDIA's data sheet, SXM part): HBM bytes per second
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}


def step_bytes(live_boundaries: float, limbs: int, batch_bytes: float,
               row_bytes: float) -> float:
    state = live_boundaries * (limbs + 1) * 4
    return 2 * state + batch_bytes + row_bytes


def least_step_s(step: dict, device_kind: str) -> float | None:
    """The least seconds a step can take on the device: its bytes at the
    peak HBM rate; None for a device missing from the table."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    nbytes = step_bytes(step["live_boundaries"], step["limbs"],
                        step["batch_bytes"], step["row_bytes"])
    return nbytes / peak["hbm_bytes_per_s"]

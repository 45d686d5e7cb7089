"""The yardstick of the roofline shares: the card's published peaks, the
least time of a piece of work, and the work of a window, counted from the
cell's configuration and mix alone, never from the route the program took.

Frozen copies, so that a change to the program cannot move the yardstick:

- ``bound_s``, ``BANDWIDTH`` and ``FP32_FLOPS`` are
  ``heat3d_tpu_torch/obs/perf/roofline.py``'s ``bound_ms`` and its rates
  (an H100 SXM's published 3.35 TB/s and 67 TFLOP/s of fp32 outside the
  tensor cores, at its 700 W limit);
- ``OPS_PER_CELL`` is ``heat3d_tpu_torch/ops/stencil_direct.py``'s
  ``chain_ops`` of the 7pt and 27pt update taps with the default factoring
  and without the Mehrstellen route (``HEAT3D_MEHRSTELLEN``): 13 and 26
  operations a cell and update.

Bytes: the field read once and written once a sweep. A sweep is
``time_blocking`` updates, and one update where the loop reads the
residual after each (the read is a sweep boundary). A residual
reads the new and the old field once.
"""

from __future__ import annotations

import subprocess
from typing import Dict

BANDWIDTH = 3.35e12  # bytes/s, H100 SXM HBM3
FP32_FLOPS = 67e12  # fp32 operations/s outside the tensor cores
OPS_PER_CELL = {"7pt": 13, "27pt": 26}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound_s(bytes_moved: float, ops: float) -> float:
    """Least seconds on the card: the bytes at its memory rate or the
    operations at its fp32 rate, whichever is larger."""
    return max(bytes_moved / BANDWIDTH, ops / FP32_FLOPS)


def cells(config: dict) -> int:
    nx, ny, nz = config["grid"]
    return nx * ny * nz


def residual_every(mix: dict) -> int:
    """Updates between the residuals the mix's loop reads back; 0 for none."""
    return int(mix.get("run", {}).get("residual_every", 0))


def sweeps(config: dict, mix: dict, updates: int) -> float:
    """Field sweeps that ``updates`` updates of the mix need at least."""
    if residual_every(mix) == 1:
        return float(updates)
    return updates / max(1, config["time_blocking"])


def stencil_bound_s(config: dict, mix: dict, updates: int) -> float:
    n = cells(config)
    moved = 2 * n * ITEMSIZE[config["storage"]] * sweeps(config, mix, updates)
    ops = n * updates * OPS_PER_CELL[config["stencil"]]
    return bound_s(moved, ops)


def residual_bound_s(config: dict, residuals: int) -> float:
    return bound_s(2 * cells(config) * ITEMSIZE[config["storage"]] * residuals, 0)


def card() -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi`` reads them (empty
    where it cannot): a share of the peak holds at the 700 W limit."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    name, _, limit = out.splitlines()[0].partition(",") if out.strip() else ("", "", "")
    return {"name": name.strip(), "power_limit": limit.strip()}

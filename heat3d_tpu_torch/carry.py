"""Carry state and taps across from the JAX reference package.

The port and ``heat3d_tpu`` are held against each other on the same inputs:
a test gathers the reference solver's field and ``solver_taps`` array as
NumPy arrays and hands them over here. Nothing in this module imports the
reference package; it only accepts what that package produces.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from heat3d_tpu_torch.core.config import SolverConfig


def taps_from_reference(taps: np.ndarray) -> np.ndarray:
    """The reference's (3,3,3) float64 update taps, unchanged (copied, so
    the caller's array stays theirs). Pass to ``HeatSolver3D(cfg, taps=...)``."""
    t = np.array(taps, dtype=np.float64, copy=True)
    if t.shape != (3, 3, 3):
        raise ValueError(f"taps must be (3,3,3), got {t.shape}")
    return t


def state_from_reference(
    u: np.ndarray, cfg: SolverConfig, device: Union[str, torch.device]
) -> torch.Tensor:
    """The reference solver's gathered field (``HeatSolver3D.gather``) as a
    contiguous tensor in the config's storage dtype on ``device``. A bf16
    field may come as ml_dtypes bfloat16 or float32; both convert exactly."""
    arr = np.asarray(u)
    if arr.shape != cfg.grid.shape:
        raise ValueError(f"field shape {arr.shape} != grid {cfg.grid.shape}")
    # a copy: the solver consumes its input field, and a gathered array
    # may be read-only
    arr = np.array(arr, dtype=np.float32 if arr.dtype.name == "bfloat16" else arr.dtype)
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=getattr(torch, cfg.precision.storage))

"""Carry state and taps across from the JAX reference package.

The port and ``heat3d_tpu`` are held against each other on the same inputs:
a test gathers the reference solver's field and ``solver_taps`` array as
NumPy arrays and hands them over here. A global field is split into the
port's shards (:func:`split_global`, uneven-decomposition padding at
``bc_value``, as the JAX package stores it) and stitched back
(:func:`stitch_global`), so both packages start from, and are compared
on, the same global field. Nothing in this module imports the reference
package; it only accepts what that package produces.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.models.heat3d import (
    ShardedField,
    global_from_shards,
    shards_from_global,
)
from heat3d_tpu_torch.parallel.topology import ShardMesh, build_shard_mesh


def taps_from_reference(taps: np.ndarray) -> np.ndarray:
    """The reference's (3,3,3) float64 update taps, unchanged (copied, so
    the caller's array stays theirs). Pass to ``HeatSolver3D(cfg, taps=...)``."""
    t = np.array(taps, dtype=np.float64, copy=True)
    if t.shape != (3, 3, 3):
        raise ValueError(f"taps must be (3,3,3), got {t.shape}")
    return t


def _host_array(u: np.ndarray) -> np.ndarray:
    """A bf16 field may come as ml_dtypes bfloat16 or float32; both convert
    exactly to float32."""
    arr = np.asarray(u)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def split_global(u: np.ndarray, cfg: SolverConfig, mesh: ShardMesh):
    """A global field (``cfg.grid.shape``) as the state of ``mesh``: one
    tensor for a (1,1,1) mesh, else a ``ShardedField``; storage dtype,
    padding at ``bc_value``."""
    us = shards_from_global(_host_array(u), cfg, mesh)
    return us[0] if len(mesh) == 1 else ShardedField(us, cfg.mesh.shape)


def stitch_global(u: Union[torch.Tensor, ShardedField], cfg: SolverConfig,
                  mesh: ShardMesh) -> np.ndarray:
    """The inverse of :func:`split_global`: the global field on the host,
    padding cropped (bf16 as float32)."""
    us = [u] if isinstance(u, torch.Tensor) else list(u.shards)
    return global_from_shards(us, cfg, mesh)


def state_from_reference(
    u: np.ndarray, cfg: SolverConfig, device: Union[str, torch.device]
):
    """The reference solver's gathered field (``HeatSolver3D.gather``) as
    the port's state on ``device`` (every shard there): a contiguous
    tensor for a (1,1,1) mesh, else a ``ShardedField``."""
    return split_global(u, cfg, build_shard_mesh(cfg, device))

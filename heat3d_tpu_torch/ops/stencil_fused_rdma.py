"""Fused in-kernel RDMA step and superstep: the fused DMA-overlap kernels
with the x-face sends split per exchange-plan sub-block.

Port of ``heat3d_tpu.ops.stencil_fused_rdma`` (``plan_send_bounds``,
``fused_rdma_supported`` / ``fused_rdma2_supported``,
``apply_step_fused_rdma`` / ``apply_superstep_fused_rdma``). The JAX module
keeps the fused DMA sweeps and swaps only the transfer protocol: each face
ships as one remote copy per y-range of the plan's decomposition
(``halo_plan='partitioned'``; a monolithic plan is the one whole-face
range), each with its own completion count. Here the same CUDA kernels
(``csrc/stencil_fused.cu``) take the plan's ranges as their send table,
one flag word per (direction, range), through a
``ops.stencil_dma_fused.FusedState`` built with those ranges.

The values do not depend on the plan: the plain versions are the fused DMA
ones (:func:`reference_fused_rdma_step`, :func:`reference_fused_rdma_superstep`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from heat3d_tpu_torch.ops import stencil_dma_fused as fd

# the fused DMA gates: the planned schedule changes how the faces ship,
# not what the sweep needs resident
fused_rdma_supported = fd.fused_dma_supported
fused_rdma2_supported = fd.fused_dma2_supported


def plan_send_bounds(plan, local_shape, itemsize: int) -> Tuple[Tuple[int, int], ...]:
    """The (start, end) y-ranges the x-face sends ship as: the plan's
    sub-block decomposition (``parallel.plan`` schedule of a
    ``halo_plan='partitioned'`` plan), or the whole face (a monolithic
    plan, or none)."""
    if plan is None:
        return ((0, int(local_shape[1])),)
    return plan.face_partition_bounds(0, local_shape, itemsize)


def reference_fused_rdma_step(us, taps, mesh, periodic=False, bc_value=0.0,
                              compute_dtype=torch.float32):
    """Plain version of :func:`apply_step_fused_rdma` (plan-independent)."""
    return fd.reference_fused_step(us, taps, mesh, periodic, bc_value,
                                   compute_dtype=compute_dtype)


def reference_fused_rdma_superstep(us, taps, mesh, periodic=False, bc_value=0.0,
                                   compute_dtype=torch.float32):
    """Plain version of :func:`apply_superstep_fused_rdma`."""
    return fd.reference_fused_superstep(us, taps, mesh, periodic, bc_value, compute_dtype)


def apply_step_fused_rdma(us: Sequence[torch.Tensor], taps: np.ndarray, mesh,
                          state: Optional[fd.FusedState] = None, periodic: bool = False,
                          bc_value: float = 0.0,
                          outs: Optional[Sequence[torch.Tensor]] = None,
                          compute_dtype: torch.dtype = torch.float32):
    """One update of every shard of an x-slab ``mesh`` in ``compute_dtype``
    with the sends of ``state.bounds`` (the plan's ranges,
    :func:`plan_send_bounds`) in flight under the interior sweep."""
    return fd._step(apply_step_fused_rdma, us, taps, mesh, state, periodic, bc_value, outs,
                    compute_dtype=compute_dtype)


def apply_superstep_fused_rdma(us: Sequence[torch.Tensor], taps: np.ndarray, mesh,
                               state: Optional[fd.FusedState] = None,
                               periodic: bool = False, bc_value: float = 0.0,
                               outs: Optional[Sequence[torch.Tensor]] = None,
                               compute_dtype: torch.dtype = torch.float32):
    """Two updates of every shard of an x-slab ``mesh`` in one sweep with
    the width-2 sends of ``state.bounds`` in flight under the interior."""
    return fd._superstep(apply_superstep_fused_rdma, us, taps, mesh, state, periodic,
                         bc_value, outs, compute_dtype=compute_dtype)


KERNELS = (apply_step_fused_rdma, apply_superstep_fused_rdma)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def generic_launch_counts() -> dict:
    """Launches of each wrapper that took the generic instance
    (``stencil_dma_fused.fused_instance``)."""
    return {k.__name__: k.generic_launches for k in KERNELS}


def cell_counts() -> dict:
    return {k.__name__: k.cells for k in KERNELS}


def compute_bf16_launch_counts() -> dict:
    """Launches of each wrapper in bf16 compute."""
    return {k.__name__: k.compute_bf16_launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = k.generic_launches = k.cells = k.compute_bf16_launches = 0


reset_launch_counts()

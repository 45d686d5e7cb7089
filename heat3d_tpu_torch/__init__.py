"""heat3d_tpu_torch — the PyTorch/CUDA port of heat3d_tpu for NVIDIA Hopper.

A second package beside the JAX one (``heat3d_tpu``), which stays the
reference it is held against: the same config in, the same taps, the same
initial field, the same result to a stated tolerance, and the fp64
``core.golden`` oracle over both. Plain tensor code is PyTorch; every Pallas
kernel on a ported path is a CUDA kernel written for ``sm_90a``
(``csrc/``, built on first use). This package never imports JAX or
``heat3d_tpu``.

What it does, as the JAX package does: the explicit-Euler solve
(``HeatSolver3D``, 7pt/27pt, fp32/bf16 storage and compute, any time
blocking k >= 1 or k = 0 resolved by the tuner, backend
auto/pallas/jnp/conv, the Mehrstellen route) on one device or over a mesh
of shards (``parallel.topology``), in one process or one process per GPU
(``parallel.distributed``; faces between processes of one host device to
device over mapped peer memory, ``parallel.wire``, ``ops.peer``), through
the direct-stencil kernels (``ops.stencil_direct``), on the exchange path
(``parallel.halo``, ``parallel.plan``) the stream and streamk kernels
(``ops.stencil_stream``) and the DMA halo kernels (``ops.halo_dma``), and on
the overlap routes the fused exchange-and-sweep kernels
(``ops.stencil_dma_fused``, ``ops.stencil_fused_rdma``); the equation
families (``eqn``) and the leapfrog and implicit-CG integrators
(``timeint``); checkpoints in the JAX package's format
(``utils.checkpoint``) and the resilience supervisor (``resilience``);
observability (``obs``), the autotuner (``tune``), serving, synchronous
and async (``serve``), and the source checkers, ``lint`` and the kernel
tier (``analysis``). A backend or a storage or compute dtype outside
these raises "not ported yet" (``core.config.check_ported``).
"""

from heat3d_tpu_torch.core.config import (
    BoundaryCondition,
    GridConfig,
    MeshConfig,
    Precision,
    RunConfig,
    SolverConfig,
    StencilConfig,
)
from heat3d_tpu_torch.core.stencils import STENCILS, Stencil, stencil_taps
from heat3d_tpu_torch.models.heat3d import HeatSolver3D

__version__ = "0.1.0"

__all__ = [
    "BoundaryCondition",
    "GridConfig",
    "MeshConfig",
    "Precision",
    "RunConfig",
    "SolverConfig",
    "StencilConfig",
    "STENCILS",
    "Stencil",
    "stencil_taps",
    "HeatSolver3D",
]

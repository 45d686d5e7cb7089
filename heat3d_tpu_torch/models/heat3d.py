"""HeatSolver3D — explicit 3D heat diffusion over a mesh of shards.

Port of ``heat3d_tpu.models.heat3d.HeatSolver3D`` for the explicit-Euler
solve: ``init_state`` -> ``run`` (fixed steps) or ``run_to_convergence``,
plus ``step``, ``step_with_residual`` and ``gather``. One process holds a
``ShardMesh`` (``parallel.topology``) of ``cfg.mesh.shape`` shards: by
default shard i on ``cuda:i``, or every shard on the one ``device`` the
caller names (``device="cpu"`` runs the kernels' plain versions, for the
tests; ``device="cuda:0"`` runs a sharded solve on one card). Without CUDA,
asking for the default device raises.

The state of a (1,1,1) mesh is its one tensor, as before; the state of a
larger mesh is a :class:`ShardedField`. Storage is ``cfg.padded_shape``:
on uneven decompositions the cells beyond ``cfg.grid.shape`` are padding
pinned at ``bc_value``, and ``gather`` crops them.

Updates go through the routes of ``parallel.step``: the direct-stencil
kernels (``ops.stencil_direct``, faces-direct on a sharded mesh), or the
exchange path (``parallel.plan``, ppermute or DMA transport) with the
stream/streamk kernels (``ops.stencil_stream``) or the backend's
plain/conv arm.

Not ported yet: checkpoints, the supervised/elastic run, slice dumps, a
mesh across processes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from heat3d_tpu_torch.core import golden
from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.core.decomposition import rank_of_coords
from heat3d_tpu_torch.ops.stencil_eager import (
    apply_taps_conv_padded,
    apply_taps_padded,
)
from heat3d_tpu_torch.ops.stencil_stream import make_stream_compute
from heat3d_tpu_torch.parallel.step import (
    LocalCompute,
    PingPong,
    _solver_taps,
    make_converge_fn,
    make_exchanges,
    make_multistep_fn,
    make_step_fn,
)
from heat3d_tpu_torch.parallel.topology import build_shard_mesh


def resolved_backend_name(cfg: SolverConfig) -> str:
    """The concrete backend name of this config's padded-block compute:
    'auto' resolves to 'pallas', the port's kernels (on the card; their
    plain versions on the CPU). Only an explicit request picks 'jnp' or
    'conv'."""
    return "pallas" if cfg.backend == "auto" else cfg.backend


def _into(fn) -> LocalCompute:
    def compute(up, taps, out=None):
        res = fn(up, taps)
        return res if out is None else out.copy_(res)

    return compute


def _select_backend(cfg: SolverConfig) -> LocalCompute:
    """The padded-block compute ``(up, taps, out=None) -> interior`` of the
    exchange path (port of the JAX ``_select_backend``):

    'pallas' / 'auto' -- the stream kernel (``make_stream_compute``);
    'jnp'  -- the plain PyTorch tap chain (``apply_taps_padded``);
    'conv' -- one ``F.conv3d`` (``apply_taps_conv_padded``), the library
              A/B arm."""
    name = resolved_backend_name(cfg)
    if name == "jnp":
        return _into(apply_taps_padded)
    if name == "conv":
        return _into(apply_taps_conv_padded)
    return make_stream_compute(cfg)


@dataclasses.dataclass
class ShardedField:
    """A field split over a mesh: the shards' tensors in rank order
    (``core.decomposition.coords_of_rank``), each of the local storage
    shape. ``field[px, py, pz]`` is the shard at those mesh coordinates."""

    shards: List[torch.Tensor]
    mesh_shape: Tuple[int, int, int]

    def __getitem__(self, coords) -> torch.Tensor:
        return self.shards[rank_of_coords(tuple(coords), self.mesh_shape)]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


def shard_slices(cfg: SolverConfig, origin) -> Tuple[Tuple[slice, ...], Tuple[slice, ...]]:
    """(global slices of the TRUE grid that the shard at ``origin`` holds,
    the same cells' local slices): empty where the shard is all padding."""
    glob = tuple(
        slice(o, min(o + n, g))
        for o, n, g in zip(origin, cfg.local_shape, cfg.grid.shape)
    )
    loc = tuple(slice(0, max(0, s.stop - s.start)) for s in glob)
    return glob, loc


def shards_from_global(arr: np.ndarray, cfg: SolverConfig, mesh) -> List[torch.Tensor]:
    """Split a global TRUE-grid field into the mesh's shards in the storage
    dtype: each shard its block, uneven-decomposition padding at
    ``bc_value``. A bf16 field may come as float32 (exact)."""
    if arr.shape != cfg.grid.shape:
        raise ValueError(f"field shape {arr.shape} != grid {cfg.grid.shape}")
    dtype = getattr(torch, cfg.precision.storage)
    out = []
    for s in mesh.shards:
        glob, loc = shard_slices(cfg, s.origin)
        t = torch.full(cfg.local_shape, cfg.stencil.bc_value, dtype=dtype, device=s.device)
        if all(sl.stop > 0 for sl in loc):
            # a copy: the solver consumes its input, which must not be the
            # caller's array
            block = np.array(arr[glob])
            t[loc] = torch.from_numpy(block).to(s.device, dtype)
        out.append(t)
    return out


def global_from_shards(us: List[torch.Tensor], cfg: SolverConfig, mesh) -> np.ndarray:
    """Stitch the shards into the global field on the host and crop the
    padding (bf16 comes back as float32, exactly)."""
    first = us[0]
    np_dtype = np.float32 if first.dtype == torch.bfloat16 else None
    full = None
    for s, u in zip(mesh.shards, us):
        block = (u.float() if u.dtype == torch.bfloat16 else u).detach().cpu().numpy()
        if full is None:
            full = np.empty(cfg.padded_shape, dtype=np_dtype or block.dtype)
        full[tuple(slice(o, o + n) for o, n in zip(s.origin, cfg.local_shape))] = block
    if full.shape != cfg.grid.shape:
        full = full[tuple(slice(0, g) for g in cfg.grid.shape)]
    return full


@dataclasses.dataclass
class RunResult:
    u: Union[torch.Tensor, ShardedField]
    steps: int
    residual: Optional[float] = None


class HeatSolver3D:
    """The step functions of one SolverConfig over its mesh of shards.

    Usage::

        cfg = SolverConfig(grid=GridConfig.cube(128))
        solver = HeatSolver3D(cfg)             # on cuda
        u = solver.init_state("hot-cube")
        u = solver.run(u, num_steps=100)

    ``taps`` overrides the config's update taps (``carry.taps_from_reference``
    hands over the JAX package's taps). ``run``/``run_to_convergence``
    consume their input field (its buffers are reused), as the JAX
    package's donated executables do; keep a copy to reuse it.
    """

    def __init__(
        self,
        cfg: SolverConfig,
        device: Union[str, torch.device, None] = None,
        taps: Optional[np.ndarray] = None,
    ):
        self.cfg = cfg
        self.mesh = build_shard_mesh(cfg, device)
        self.device = self.mesh.shards[0].device
        self.taps = _solver_taps(cfg) if taps is None else np.asarray(
            taps, dtype=np.float64
        )
        self._pp = PingPong()
        self._ex = make_exchanges(cfg, self.mesh)
        self._compute = _select_backend(cfg)
        args = (cfg, self.mesh, self.taps)
        self._step = make_step_fn(*args, False, self._compute, self._ex)
        self._step_res = make_step_fn(*args, True, self._compute, self._ex)
        self._converge = make_converge_fn(*args, self._pp, self._compute, self._ex)
        # built on first use, as in the JAX package: the superstep's extent
        # check belongs to the fixed-step loop
        self._multistep_cache = None

    @property
    def _multistep(self):
        if self._multistep_cache is None:
            self._multistep_cache = make_multistep_fn(
                self.cfg, self.mesh, self.taps, self._pp, self._compute, self._ex
            )
        return self._multistep_cache

    @property
    def storage_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.precision.storage)

    # ---- state <-> shards --------------------------------------------------

    def _shards(self, u) -> List[torch.Tensor]:
        if isinstance(u, ShardedField):
            if len(u.shards) != len(self.mesh):
                raise ValueError(
                    f"field of {len(u.shards)} shards, mesh has {len(self.mesh)}"
                )
            return list(u.shards)
        if isinstance(u, torch.Tensor) and len(self.mesh) == 1:
            return [u]
        raise TypeError(
            f"a mesh of {len(self.mesh)} shards takes a ShardedField, got "
            f"{type(u).__name__}"
        )

    def _wrap(self, us: List[torch.Tensor]):
        if len(self.mesh) == 1:
            return us[0]
        return ShardedField(list(us), self.cfg.mesh.shape)

    def _on_shards(self, fn, u, *args):
        """``fn(shards, *args)`` with the shard streams tied to the caller's."""
        self.mesh.fork()
        res = fn(self._shards(u), *args)
        self.mesh.join()
        return res

    # ---- state -----------------------------------------------------------

    def init_state(self, init: Union[str, np.ndarray] = "hot-cube"):
        """The initial field on the shards' devices, of the storage shape
        (padding at bc_value). ``hot-cube`` is built on the device (its
        values 0 and 1 are exact in every storage dtype); the other named
        initializers come from ``core.golden.make_init_block`` on each
        shard's clipped global slices (float32, then rounded to storage),
        so they are byte-equal to the JAX package's; an array of the grid
        shape is split as given."""
        if isinstance(init, np.ndarray):
            return self._wrap(shards_from_global(init, self.cfg, self.mesh))
        if init == "hot-cube":
            return self._wrap(self._device_field(hot_cube=True))
        cfg = self.cfg
        us = []
        for s in self.mesh.shards:
            glob, loc = shard_slices(cfg, s.origin)
            t = torch.full(cfg.local_shape, cfg.stencil.bc_value,
                           dtype=self.storage_dtype, device=s.device)
            if all(sl.stop > 0 for sl in loc):
                block = golden.make_init_block(init, cfg.grid.shape, glob,
                                               seed=cfg.run.seed)
                t[loc] = torch.from_numpy(block).to(s.device).to(self.storage_dtype)
            us.append(t)
        return self._wrap(us)

    def _device_field(self, hot_cube: bool) -> List[torch.Tensor]:
        """Zero (or hot-cube) true grid, padding at bc_value, built on the
        devices shard by shard (same bounds arithmetic as
        golden.make_init_block)."""
        cfg = self.cfg
        us = []
        for s in self.mesh.shards:
            glob, loc = shard_slices(cfg, s.origin)
            u = torch.full(cfg.local_shape, cfg.stencil.bc_value,
                           dtype=self.storage_dtype, device=s.device)
            u[loc] = 0.0
            if hot_cube:
                cube = []
                for n, o, sl in zip(cfg.grid.shape, s.origin, loc):
                    g0 = int(n * (0.5 - 0.25 / 2))
                    g1 = max(int(n * (0.5 + 0.25 / 2)), g0 + 1)
                    cube.append(slice(min(max(g0 - o, 0), sl.stop),
                                      min(max(g1 - o, 0), sl.stop)))
                u[tuple(cube)] = 1.0
            us.append(u)
        return us

    def zeros_state(self):
        return self._wrap(self._device_field(hot_cube=False))

    # ---- stepping --------------------------------------------------------

    def step(self, u):
        return self._wrap(self._on_shards(self._step, u))

    def step_with_residual(self, u):
        """One update and the float32 sum of squared changes (a 0-d tensor
        on the first shard's device; sqrt of it is the L2 residual)."""
        us, r2 = self._on_shards(self._step_res, u)
        return self._wrap(us), r2

    def run(self, u, num_steps: int):
        """``num_steps`` updates (time_blocking k > 1: ``num_steps // k``
        supersteps, then the remainder as single steps). Consumes ``u``."""
        return self._wrap(self._on_shards(self._multistep, u, int(num_steps)))

    def run_to_convergence(self, u, tol: float, max_steps: int) -> RunResult:
        us, steps, res = self._on_shards(self._converge, u, int(max_steps), float(tol))
        return RunResult(u=self._wrap(us), steps=steps, residual=res)

    # ---- IO --------------------------------------------------------------

    def gather(self, u) -> np.ndarray:
        """The global field on the host, the storage padding cropped. bf16
        storage comes back as float32 (NumPy has no bfloat16; the
        conversion is exact)."""
        return global_from_shards(self._shards(u), self.cfg, self.mesh)

"""HeatSolver3D — the 3D heat equation and its equation families over a
mesh of shards.

Port of ``heat3d_tpu.models.heat3d.HeatSolver3D``: ``init_state`` ->
``run`` (fixed steps) or ``run_to_convergence``, plus ``step``,
``step_with_residual`` and ``gather``. The equation family
(``cfg.equation``, ``cfg.eq_params``) only changes the update taps. A
non-Euler integrator (``cfg.integrator``: ``leapfrog``, ``implicit-cg``)
pins its auto knobs and runs the step functions of ``heat3d_tpu_torch.timeint``
instead of the kernel routes: under leapfrog the state is the two-level
carry ``(u, u_prev)``, and an implicit-cg ``run`` keeps its last solve's
iteration count and relative residual as ``last_cg_stats``. One process
holds a ``ShardMesh`` (``parallel.topology``) of ``cfg.mesh.shape`` shards: by
default shard i on ``cuda:i``, or every shard on the one ``device`` the
caller names (``device="cpu"`` runs the kernels' plain versions, for the
tests; ``device="cuda:0"`` runs a sharded solve on one card). Without CUDA,
asking for the default device raises.

The state of a (1,1,1) mesh is its one tensor, as before; the state of a
larger mesh is a :class:`ShardedField`. Storage is ``cfg.padded_shape``:
on uneven decompositions the cells beyond ``cfg.grid.shape`` are padding
pinned at ``bc_value``, and ``gather`` crops them.

Updates go through the routes of ``parallel.step``: the direct-stencil
kernels (``ops.stencil_direct``, faces-direct on a sharded mesh), the
exchange path (``parallel.plan``, ppermute or DMA transport, monolithic or
partitioned plan) with the stream/streamk kernels (``ops.stencil_stream``)
or the backend's plain/conv arm, or the overlap routes (``overlap``,
``fused_rdma``): the fused exchange-and-sweep kernels
(``ops.stencil_dma_fused``, ``ops.stencil_fused_rdma``) and the
interior/boundary split.

State: ``save_checkpoint``/``load_checkpoint`` write and read the JAX
package's checkpoint format (``utils.checkpoint``; a leapfrog carry's
second level under ``level-1/``), so a run moves between meshes and
between the packages; ``run_supervised`` drives the resilience supervisor
(``resilience.supervisor``). Under explicit Euler the auto knobs
(``backend``, ``halo``, ``halo_plan``, ``fused_rdma`` 'auto',
``time_blocking=0``) resolve through the tuning cache
(``tune.cache.resolve_config``) for the solver's placement before anything
is built. Not ported yet: a mesh across processes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from heat3d_tpu_torch import obs, timeint
from heat3d_tpu_torch.core import golden
from heat3d_tpu_torch.core.config import DEFAULT_INTEGRATOR, SolverConfig
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
from heat3d_tpu_torch.utils import checkpoint as ckpt


def resolved_backend_name(cfg: SolverConfig) -> str:
    """The concrete backend name of this config's padded-block compute:
    'auto' resolves to 'pallas', the port's kernels (on the card; their
    plain versions on the CPU). Only an explicit request picks 'jnp' or
    'conv'."""
    return "pallas" if cfg.backend == "auto" else cfg.backend


def _into(fn, compute_dtype: torch.dtype) -> LocalCompute:
    """``fn(up, taps)`` in ``compute_dtype`` as a padded-block compute;
    ``compute.plain`` names ``fn``, so the overlap split's faces can follow
    its route."""
    def compute(up, taps, out=None):
        res = fn(up, taps, compute_dtype=compute_dtype)
        return res if out is None else out.copy_(res)

    compute.plain = fn
    return compute


def _select_backend(cfg: SolverConfig) -> LocalCompute:
    """The padded-block compute ``(up, taps, out=None) -> interior`` of the
    exchange path (port of the JAX ``_select_backend``):

    'pallas' / 'auto' -- the stream kernel (``make_stream_compute``);
    'jnp'  -- the plain PyTorch update (``apply_taps_padded``: the tap
              chain, or the Mehrstellen route under ``HEAT3D_MEHRSTELLEN``,
              as the JAX jnp apply);
    'conv' -- one ``F.conv3d`` (``apply_taps_conv_padded``), the library
              A/B arm.

    Each computes in the config's compute dtype (``cfg.precision.compute``)."""
    name = resolved_backend_name(cfg)
    compute_dtype = getattr(torch, cfg.precision.compute)
    if name == "jnp":
        return _into(apply_taps_padded, compute_dtype)
    if name == "conv":
        return _into(apply_taps_conv_padded, compute_dtype)
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
    hands over the JAX package's taps) under explicit Euler.
    ``run``/``run_to_convergence`` consume their input field (its buffers
    are reused), as the JAX package's donated executables do; keep a copy
    to reuse it.
    """

    def __init__(
        self,
        cfg: SolverConfig,
        device: Union[str, torch.device, None] = None,
        taps: Optional[np.ndarray] = None,
    ):
        explicit = cfg.integrator == DEFAULT_INTEGRATOR
        if not explicit:
            if taps is not None:
                raise ValueError(
                    f"a taps override applies to explicit-euler; integrator "
                    f"{cfg.integrator!r} derives its own from the config")
            # the non-default integrators pin their auto knobs and validate
            # against the timeint step functions' scope, as in the JAX package
            cfg = timeint.pin_config(cfg)
            timeint.validate_config(cfg)
        else:
            # the auto knobs resolve through the tuning cache: the safety
            # net for library callers (the command line and the bench
            # resolve at their entry points, so their run_start and rows
            # record the concrete route); it fails soft to the static
            # defaults
            from heat3d_tpu_torch.tune.cache import resolve_config

            cfg = resolve_config(cfg, device=device)
        self.cfg = cfg
        # the placement and taps asked for: a supervised recovery rebuilds
        # the solver (on a survivor mesh too) with the same ones
        self._placement = device
        self._taps_override = taps
        self.mesh = build_shard_mesh(cfg, device)
        self.device = self.mesh.shards[0].device
        self.taps = _solver_taps(cfg) if taps is None else np.asarray(
            taps, dtype=np.float64
        )
        self._pp = PingPong()
        self._ex = make_exchanges(cfg, self.mesh)
        self._multistep_cache = None
        # the last implicit-cg run's (iterations, relative residual)
        self.last_cg_stats: Optional[Tuple[int, float]] = None
        if not explicit:
            # one set of Krylov vectors for every CG step function of the solver
            self._workspace = {}
            kw = dict(exchanges=self._ex, workspace=self._workspace)
            self._compute = None
            self._step = timeint.make_step_fn(cfg, self.mesh, **kw)
            self._step_res = timeint.make_step_fn(cfg, self.mesh, with_residual=True, **kw)
            # convergence mode is steady-state machinery: wave runs oscillate
            # and an implicit solve's change residual measures dt
            self._converge = None
            return
        self._compute = _select_backend(cfg)
        args = (cfg, self.mesh, self.taps)
        self._step = make_step_fn(*args, False, self._compute, self._ex)
        self._step_res = make_step_fn(*args, True, self._compute, self._ex)
        self._converge = make_converge_fn(*args, self._pp, self._compute, self._ex)

    @property
    def _multistep(self):
        # built on first use, as in the JAX package: the superstep's extent
        # check belongs to the fixed-step loop
        if self._multistep_cache is None:
            if self._compute is None:
                self._multistep_cache = timeint.make_multistep_fn(
                    self.cfg, self.mesh, self._ex, self._pp, self._workspace)
            else:
                self._multistep_cache = make_multistep_fn(
                    self.cfg, self.mesh, self.taps, self._pp, self._compute, self._ex
                )
        return self._multistep_cache

    @property
    def _leapfrog(self) -> bool:
        return self.cfg.integrator == "leapfrog"

    @property
    def storage_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.precision.storage)

    # ---- state <-> shards --------------------------------------------------

    def _shards(self, u):
        """The shard list of a state; a pair of them for a two-level carry."""
        if isinstance(u, tuple):
            return tuple(self._shards(level) for level in u)
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

    def _wrap_state(self, res):
        """The state of a step's result: a level pair under leapfrog."""
        if self._leapfrog:
            return tuple(self._wrap(level) for level in res)
        return self._wrap(res)

    def _on_shards(self, fn, u, *args):
        """``fn(shards, *args)`` with the shard streams tied to the caller's."""
        self.mesh.fork()
        res = fn(self._shards(u), *args)
        self.mesh.join()
        return res

    # ---- state -----------------------------------------------------------

    def init_state(self, init: Union[str, np.ndarray, tuple] = "hot-cube"):
        """The initial field on the shards' devices, of the storage shape
        (padding at bc_value). ``hot-cube`` is built on the device (its
        values 0 and 1 are exact in every storage dtype); the other named
        initializers come from ``core.golden.make_init_block`` on each
        shard's clipped global slices (float32, then rounded to storage),
        so they are byte-equal to the JAX package's; an array of the grid
        shape is split as given.

        Under ``integrator='leapfrog'`` the state is the two-level carry
        ``(u, u_prev)``: a single initializer gives a zero-velocity start
        (u_prev a copy of u, in buffers of its own); a tuple of two
        initializers sets each level."""
        if self._leapfrog:
            if isinstance(init, tuple):
                if len(init) != 2:
                    raise ValueError(
                        f"leapfrog init tuple must have 2 levels (u, "
                        f"u_prev), got {len(init)}"
                    )
                return tuple(self._init_level(level) for level in init)
            u0 = self._init_level(init)
            return (u0, self._copy(u0))
        return self._init_level(init)

    def _copy(self, u):
        return self._wrap([t.clone() for t in self._shards(u)])

    def _init_level(self, init: Union[str, np.ndarray]):
        with obs.get().span(
            "init_state",
            init=init if isinstance(init, str) else "array",
            grid=list(self.cfg.grid.shape),
        ):
            return self._init_level_shards(init)

    def _init_level_shards(self, init: Union[str, np.ndarray]):
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
        """An all-zero true grid (padding at bc_value); a two-level pair of
        them under leapfrog."""
        z = self._wrap(self._device_field(hot_cube=False))
        return (z, self._copy(z)) if self._leapfrog else z

    # ---- stepping --------------------------------------------------------

    def step(self, u):
        return self._wrap_state(self._on_shards(self._step, u))

    def step_with_residual(self, u):
        """One update and the float32 sum of squared changes (a 0-d tensor
        on the first shard's device; sqrt of it is the L2 residual)."""
        us, r2 = self._on_shards(self._step_res, u)
        return self._wrap_state(us), r2

    def run(self, u, num_steps: int):
        """``num_steps`` updates (time_blocking k > 1: ``num_steps // k``
        supersteps, then the remainder as single steps). Consumes ``u``.
        Under ``implicit-cg`` each update is a CG solve; the last solve's
        iteration count and relative residual are read once, after the
        loop, into ``last_cg_stats`` and the ledger's ``cg_solve`` event."""
        if self.cfg.integrator == "implicit-cg":
            us, iters, relres = self._on_shards(self._multistep, u, int(num_steps))
            self.last_cg_stats = (int(iters), float(relres))
            obs.get().event(
                "cg_solve",
                steps=int(num_steps),
                cg_iters=self.last_cg_stats[0],
                cg_relres=self.last_cg_stats[1],
            )
            return self._wrap(us)
        return self._wrap_state(self._on_shards(self._multistep, u, int(num_steps)))

    def run_to_convergence(self, u, tol: float, max_steps: int) -> RunResult:
        if self._converge is None:
            raise ValueError(
                f"run_to_convergence needs integrator='explicit-euler' "
                f"(got {self.cfg.integrator!r}): wave runs oscillate "
                "instead of converging, and an implicit solve's change "
                "residual measures dt, not steady-state proximity — use "
                "fixed-step run() (docs/INTEGRATORS.md)"
            )
        us, steps, res = self._on_shards(self._converge, u, int(max_steps), float(tol))
        return RunResult(u=self._wrap(us), steps=steps, residual=res)

    def run_supervised(self, total_steps: int, ckpt_root: str,
                       checkpoint_every: int = 0, **kwargs):
        """Run to global step ``total_steps`` under the resilience
        supervisor (``resilience.supervisor.run_supervised``, whose knobs
        ``kwargs`` pass on): checkpoint generations every
        ``checkpoint_every`` steps into ``ckpt_root``, auto-resume from the
        newest good generation, survive backend loss or hang by waiting for
        heal and resuming. By default a recovery rebuilds a solver for this
        config (or, under ``heal_mode='elastic'|'auto'``, a survivor
        config) with this solver's placement and taps, and the heal probe
        must find this solver's device type (``want_platform``)."""
        from heat3d_tpu_torch.resilience.supervisor import run_supervised

        device, taps = self._placement, self._taps_override
        kwargs.setdefault("make_solver", lambda: HeatSolver3D(self.cfg, device, taps))
        kwargs.setdefault("make_solver_for", lambda cfg: HeatSolver3D(cfg, device, taps))
        kwargs.setdefault("base_cfg", self.cfg)
        kwargs.setdefault("want_platform", self.device.type)
        return run_supervised(self, total_steps, ckpt_root, checkpoint_every, **kwargs)

    # ---- IO --------------------------------------------------------------

    def gather(self, u) -> np.ndarray:
        """The global field on the host, the storage padding cropped. bf16
        storage comes back as float32 (NumPy has no bfloat16; the
        conversion is exact). A two-level carry gathers level 0."""
        if isinstance(u, tuple):
            u = u[0]
        return global_from_shards(self._shards(u), self.cfg, self.mesh)

    def gather_slice(self, u, axis: int, index: int) -> np.ndarray:
        """One global 2D plane of the field on the host (the JAX
        ``gather_slice``, the reference class's visualization dump): the
        plane at GLOBAL ``index`` along ``axis``, copied from the shards
        that hold it, padding cropped, never the whole field. bf16 comes
        back as float32. A two-level carry gives level 0's plane."""
        if isinstance(u, tuple):
            u = u[0]
        cfg = self.cfg
        g = cfg.grid.shape
        if not 0 <= axis <= 2:
            raise ValueError(f"slice axis must be 0..2, got {axis}")
        if not 0 <= index < g[axis]:
            raise ValueError(
                f"slice index {index} outside grid extent {g[axis]} on axis {axis}"
            )
        others = [a for a in range(3) if a != axis]
        plane = None
        for s, t in zip(self.mesh.shards, self._shards(u)):
            origin = s.origin[axis]
            if not origin <= index < origin + cfg.local_shape[axis]:
                continue
            glob, loc = shard_slices(cfg, s.origin)
            if any(loc[a].stop == 0 for a in others):
                continue  # all padding on this plane
            block = t.select(axis, index - origin)[loc[others[0]], loc[others[1]]]
            block = (block.float() if block.dtype == torch.bfloat16 else block).cpu().numpy()
            if plane is None:
                plane = np.empty([g[a] for a in others], dtype=block.dtype)
            plane[glob[others[0]], glob[others[1]]] = block
        return plane

    def save_checkpoint(self, path: str, u, step: int, stats: Optional[dict] = None) -> None:
        """Checkpoint the state in the JAX package's format
        (``utils.checkpoint.save``; ``stats`` gains its timings). A
        two-level carry (leapfrog) writes level 0 at ``path`` — the
        manifest's extra records ``levels``/``integrator`` — and level 1 as
        a full checkpoint under ``<path>/level-1/``."""
        levels = timeint.carry_levels(self.cfg.integrator)
        if levels == 1:
            ckpt.save(path, u, step, extra={"config": repr(self.cfg)}, stats=stats)
            return
        ckpt.save(path, u[0], step, stats=stats, extra={
            "config": repr(self.cfg),
            "levels": levels,
            "integrator": self.cfg.integrator,
        })
        for lv in range(1, levels):
            ckpt.save(os.path.join(path, f"level-{lv}"), u[lv], step, stats=stats,
                      extra={"level": lv, "integrator": self.cfg.integrator})

    def load_checkpoint(self, path: str, stats: Optional[dict] = None):
        """``(state, step)`` of a checkpoint saved by either package's
        ``save_checkpoint``, on any mesh with this config's storage shape
        (``utils.checkpoint.load`` stitches across meshes). The level
        structure is validated BEFORE any shard read: a ``levels`` count
        that disagrees with this integrator's carry, a missing level
        directory, a level step drift or a per-level storage-shape
        mismatch raises :class:`heat3d_tpu_torch.timeint.MultiLevelCheckpointError`
        — a ValueError, so the supervisor's resume scan skips the
        generation in place (the shards are not proven corrupt)."""
        levels = timeint.carry_levels(self.cfg.integrator)
        man = ckpt.load_manifest(path)
        found = int((man.get("extra") or {}).get("levels", 1))
        if found != levels:
            raise timeint.MultiLevelCheckpointError(
                f"checkpoint {path} holds {found} field level(s) but "
                f"integrator {self.cfg.integrator!r} carries {levels} — "
                "wrong integrator for this checkpoint (docs/INTEGRATORS.md)"
            )
        u, step = self._load_level(path, stats=stats)
        if levels == 1:
            return u, step
        state = [u]
        for lv in range(1, levels):
            lp = os.path.join(path, f"level-{lv}")
            try:
                ulv, step_lv = self._load_level(
                    lp, error_cls=timeint.MultiLevelCheckpointError, stats=stats
                )
            except ckpt.ShardCorruptError:
                raise  # proven damage: let the supervisor quarantine
            except FileNotFoundError as e:
                raise timeint.MultiLevelCheckpointError(
                    f"checkpoint {path} is missing level {lv} ({lp}): {e}"
                ) from e
            if step_lv != step:
                raise timeint.MultiLevelCheckpointError(
                    f"checkpoint {path} level {lv} is at step {step_lv} "
                    f"but level 0 is at step {step} — torn multi-level save"
                )
            state.append(ulv)
        return tuple(state), step

    def _load_level(self, path: str, error_cls=ValueError, stats=None):
        shape = tuple(ckpt.load_manifest(path)["global_shape"])
        if shape != self.cfg.padded_shape:
            # fail loudly: silently stepping a wrong-shape field would
            # finish "successfully" with metrics of the CONFIGURED grid.
            # Padding only ever rounds the grid UP, so saved >= grid on
            # every dim is consistent with "same grid, other mesh's
            # padding"; any smaller dim proves a different grid outright
            same_grid_other_padding = all(
                s >= g for s, g in zip(shape, self.cfg.grid.shape)
            )
            hint = (
                "the checkpoint was padded for a different mesh "
                "(cross-mesh resume across bc-paddings is unsupported — "
                "use a grid divisible by both meshes, or consolidate and "
                "re-grid)"
                if same_grid_other_padding
                else "wrong checkpoint for this run"
            )
            raise error_cls(
                f"checkpoint {path} holds a {shape} field but "
                f"this config's storage shape is {self.cfg.padded_shape} "
                f"(grid {self.cfg.grid.shape} on mesh {self.cfg.mesh.shape})"
                f" — {hint}"
            )
        u, step, _ = ckpt.load(path, self.mesh, stats=stats)
        if u.dtype != self.storage_dtype:
            u = self._wrap([t.to(self.storage_dtype) for t in self._shards(u)])
        return u, step

"""EnsembleSolver — the leading batch axis through the step.

Port of ``heat3d_tpu.serve.ensemble``. One batched loop advances B
independent scenarios (distinct initial conditions, Dirichlet boundary
values, diffusivities/timesteps, step budgets) over one structural config.
The batch dimension threads through the exchange-path machinery: a member's
update is the plain chain step of the ``jnp`` arm (exchange, tap chain,
ghost-ring pins), run on a (B, nx, ny, nz) block per shard: the batched
axis-ordered exchange (``parallel.plan.BatchedExchangePlan``, per-member
boundary values as a tensor) and the parametric chain
(``ops.stencil_eager.apply_taps_padded_params``, per-member taps as a
(B, T) tensor in the chain's emission order).

Two coefficient-binding modes, as in the JAX package:

- ``bind='traced'`` (default, the serving mode): the members' taps,
  boundary values and budgets are tensors of one batched loop, so a shape
  bucket keeps its plans and serves any member values. Each multiply and
  add is one eager elementwise operation of the compute dtype on a
  broadcast weight, so a member's result does not depend on its batch:
  B=1 equals B=64 member-wise, bitwise. A member's residual is reduced on
  its own (nx, ny, nz) view through ``stencil_eager.residual_sumsq``, never
  over the batch, so it does not depend on the packing either. The
  weights are rounded on the host as the solo path rounds its embedded
  ones (``stencil_eager.compute_weight``), so a member also matches a solo
  ``HeatSolver3D(backend='jnp')`` run; the JAX package promises only the
  last ulp there (XLA may contract a constant and a parameter differently).
- ``bind='baked'``: each member runs the solo loop itself
  (``parallel.step.make_multistep_fn`` of its own config, ``backend='jnp'``)
  over the spatial mesh, sliced out of and stacked back into the batched
  state: bitwise-identical to B solo runs by construction, at B loops per
  call. Needs ``batch_mesh == 1``.

Batch-aware layout: ``batch_mesh = Pb`` splits the members into Pb groups
of B/Pb, each group over its own copy of the spatial mesh ((Px, Py, Pz)
shards): Pb * Px*Py*Pz shards, shard i on ``cuda:i`` by default or every
shard on the one ``device`` the caller names (``cpu`` for the tests,
``cuda:0`` on one card). Groups never exchange: members are independent.
The state is a :class:`BatchedField`, the shards in rank order over
(b, x, y, z). The tune cache resolves ``time_blocking=0`` through the
batch-bucketed key (``tune.cache.cache_key(batch_size=B)``).

Scope: the plain chain on the axis-ordered ppermute exchange in one
process, as the JAX ensemble runs its jnp chain. The kernel routes embed
their coefficients in the launch and stay single-tenant; no hand-written
kernel launches on this path. The variable-coefficient route
(``timeint.coeffield``) runs the flux-form update with the members'
fields as a second batched array, exchanged once per bind with bc 0.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core import golden
from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.core.stencils import (
    decompose_mehrstellen,
    flat_taps,
    mehrstellen_enabled,
)
from heat3d_tpu_torch.models.heat3d import shard_slices
from heat3d_tpu_torch.obs.trace import named_phase
from heat3d_tpu_torch.ops.stencil_eager import (
    _apply_mehrstellen_padded,
    apply_taps_padded_params,
    compute_weight,
    emission_positions,
    member_weights,
    residual_sumsq,
)
from heat3d_tpu_torch.parallel.plan import BatchedExchangePlan
from heat3d_tpu_torch.parallel.step import (
    PHASE_STENCIL,
    PHASE_STEP,
    _fill_mid_ghosts,
    _pin_padding,
    _solver_taps,
)
from heat3d_tpu_torch.parallel.topology import ShardMesh, mesh_devices
from heat3d_tpu_torch.serve.scenario import ScenarioBatch
from heat3d_tpu_torch.utils import checkpoint as ckpt


def _resolve_base(base: SolverConfig, batch_size: int, device=None) -> SolverConfig:
    """Auto-knob resolution for the ensemble. ``backend='auto'`` and
    ``halo='auto'`` are pinned to the chain/ppermute FIRST — the solo tune
    cache's winner for them is typically a single-tenant kernel route,
    which the ensemble cannot run. Only then do the remaining auto knobs
    (``time_blocking=0``) resolve through the batch-bucketed key
    (resolution fails soft to the static defaults)."""
    kw = {}
    if base.backend == "auto":
        kw["backend"] = "jnp"
    if base.halo == "auto":
        kw["halo"] = "ppermute"
    if kw:
        base = dataclasses.replace(base, **kw)
    try:
        from heat3d_tpu_torch.tune.cache import resolve_config

        return resolve_config(base, batch_size=batch_size, device=device)
    except Exception:  # noqa: BLE001 - resolution is optional
        if base.time_blocking == 0:
            return dataclasses.replace(base, time_blocking=1)
        return base


@dataclasses.dataclass
class BatchedField:
    """An ensemble's state: each shard's (B/Pb, nx, ny, nz) block of its
    group's members, in rank order over the (Pb, Px, Py, Pz) mesh."""

    shards: List[torch.Tensor]
    mesh_shape: Tuple[int, int, int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


@dataclasses.dataclass(eq=False)
class _Slot:
    """One shard of the batched layout, as ``utils.checkpoint`` and
    ``utils.timing.force_sync`` read a shard."""

    origin: Tuple[int, int, int, int]
    device: torch.device


class _BatchLayout:
    """The (Pb, Px, Py, Pz) layout of an ensemble's shards: what the
    checkpoint load, ``force_sync`` and the supervisor read of a mesh."""

    multiprocess = False

    def __init__(self, shape, local_shape, slots: List[_Slot]):
        self.shape = tuple(shape)
        self.local_shape = tuple(local_shape)
        self.local_shards = slots

    def __len__(self) -> int:
        return len(self.local_shards)


class EnsembleSolver:
    """B scenarios, one batched loop. See the module docstring.

    Usage::

        batch = ScenarioBatch(SolverConfig(grid=GridConfig.cube(64),
                                           backend="jnp"),
                              [Scenario(alpha=0.3, bc_value=1.0),
                               Scenario(alpha=0.5, steps=200)])
        es = EnsembleSolver(batch)          # traced binding, on the card
        u = es.init_state()                 # BatchedField (B, *padded)
        u = es.run(u)                       # per-member budgets (masked)
        fields = es.gather(u)               # (B, *grid) on the host
    """

    def __init__(
        self,
        batch: ScenarioBatch,
        batch_mesh: int = 1,
        bind: str = "traced",
        device: Union[str, torch.device, None] = None,
    ):
        if bind not in ("traced", "baked"):
            raise ValueError(f"bind must be traced|baked, got {bind!r}")
        self.batch = batch
        self.B = len(batch)
        self.bind = bind
        self.batch_mesh = int(batch_mesh)
        self._placement = device
        cfg = _resolve_base(batch.base, self.B, device)
        if cfg.integrator != "explicit-euler":
            raise ValueError(
                f"integrator={cfg.integrator!r}: the ensemble packs the "
                "explicit sweep (and its variable-coefficient flux form); "
                "the leapfrog two-level carry and the CG solve are "
                "single-tenant — run them through HeatSolver3D "
                "(docs/INTEGRATORS.md)"
            )
        self._varcoef = bool(getattr(batch, "has_coef_fields", False))
        if self._varcoef and bind != "traced":
            raise ValueError(
                "coefficient-field members need bind='traced': the field "
                "arrays are runtime inputs of one shared program (the "
                "baked binding dispatches constant-coefficient solo "
                "executables)"
            )
        if cfg.backend in ("pallas", "conv"):
            raise ValueError(
                f"backend={cfg.backend!r} bakes its coefficients into the "
                "kernel/conv program; the ensemble threads per-member "
                "coefficients as runtime inputs — use backend 'jnp' (or "
                "'auto', which the ensemble pins to the chain)"
            )
        if cfg.halo != "ppermute":
            raise ValueError(
                f"halo={cfg.halo!r}: the ensemble path runs the portable "
                "axis-ordered ppermute exchange (the DMA kernels are "
                "single-tenant)"
            )
        if cfg.halo_order != "axis":
            raise ValueError(
                "halo_order='pairwise' is a single-tenant exchange A/B "
                "knob; the ensemble pins axis ordering"
            )
        if cfg.overlap:
            raise ValueError(
                "overlap=True splits the step for a single tenant; the "
                "ensemble's members already fill the schedule — drop it"
            )
        # the ensemble's compute route is the chain; record it concretely
        cfg = dataclasses.replace(cfg, backend="jnp")
        k = cfg.time_blocking
        if self._varcoef and k > 1:
            raise ValueError(
                f"time_blocking={k} with coefficient fields: the "
                "superstep ring recompute carries the solution only — "
                "the flux form needs the field's ghosts every update "
                "(tb=1; docs/INTEGRATORS.md)"
            )
        if k > 1 and min(cfg.local_shape) < max(3, k):
            raise ValueError(
                f"time_blocking={k} needs local extents >= {max(3, k)} "
                f"(k ghost layers plus the shrinking recompute rings), "
                f"got {cfg.local_shape}"
            )
        self.cfg = cfg
        self.k = max(1, k)

        if self.batch_mesh < 1 or self.B % self.batch_mesh:
            raise ValueError(
                f"batch_mesh={batch_mesh} must divide the batch size "
                f"{self.B}"
            )
        if bind == "baked" and self.batch_mesh != 1:
            raise ValueError(
                "bind='baked' needs batch_mesh=1: members sharded across "
                "devices would need per-device constants, which one SPMD "
                "program cannot carry — use bind='traced' to factorize "
                "the mesh over batch"
            )
        from heat3d_tpu_torch.parallel import distributed

        if distributed.process_count() > 1:
            raise ValueError(
                "the ensemble runs in one process (the batched exchange "
                "has no wire between processes)")
        P = cfg.mesh.num_devices
        total = self.batch_mesh * P
        if device is None and torch.cuda.is_available() and total > 1 \
                and torch.cuda.device_count() < total:
            raise ValueError(
                f"ensemble mesh b={self.batch_mesh} x space "
                f"{cfg.mesh.shape} needs {total} devices, only "
                f"{torch.cuda.device_count()} visible"
            )
        devs = mesh_devices(total, device)
        self.Bl = self.B // self.batch_mesh
        self.groups: List[ShardMesh] = [
            ShardMesh(cfg.mesh.shape, cfg.local_shape, devs[g * P:(g + 1) * P],
                      processes=(1, 0))
            for g in range(self.batch_mesh)
        ]
        self.device = self.groups[0].local_shards[0].device
        slots = []
        for g, mesh in enumerate(self.groups):
            for s in mesh.local_shards:
                slots.append(_Slot((g * self.Bl,) + tuple(s.origin), s.device))
        self.mesh = _BatchLayout((self.batch_mesh,) + tuple(cfg.mesh.shape),
                                 (self.Bl,) + tuple(cfg.local_shape), slots)
        self._plans = {}
        self._build_coefficients()
        self._build_programs()

    # ---- coefficient packing ---------------------------------------------

    @property
    def storage_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.precision.storage)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.precision.compute)

    def _group_members(self, g: int) -> range:
        return range(g * self.Bl, (g + 1) * self.Bl)

    def _per_group(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A (B, ...) host tensor split into the groups' (B/Pb, ...) slices,
        each on its group's device."""
        return [t[g * self.Bl:(g + 1) * self.Bl].to(mesh.local_shards[0].device)
                for g, mesh in enumerate(self.groups)]

    def _plan(self, g: int, width: int) -> BatchedExchangePlan:
        key = (g, width)
        p = self._plans.get(key)
        if p is None:
            p = self._plans[key] = BatchedExchangePlan(
                self.groups[g], self.cfg.stencil.bc, width, self.storage_dtype, self.Bl)
        return p

    def _build_coefficients(self) -> None:
        """The members' values as tensors, uploaded once per (re)bind: the
        budgets, the boundary values (storage dtype, rounded as a solo
        fill rounds them), and the chain weights, the Mehrstellen
        coefficients or the coefficient fields. The plans stay: a rebind
        (the queue's bucket reuse) changes values, not shapes."""
        cfg = self.cfg
        cd, sd = self.compute_dtype, self.storage_dtype
        self.budgets = np.asarray(
            [self.batch.member_steps(m) for m in range(self.B)], dtype=np.int32)
        bcv = torch.stack([
            torch.full((), float(m.bc_value), dtype=sd) for m in self.batch.members
        ]).reshape(self.B, 1, 1, 1)
        self._BCV = self._per_group(bcv)
        self._W = self._COEF = self._A_pads = self._DT = None
        self._mehrstellen = False
        if self._varcoef:
            from heat3d_tpu_torch.timeint.coeffield import dt_factors

            # per-member coefficient fields, storage padding ZERO (a=0 kills
            # the face flux out of the pad), exchanged ONCE per bind with bc
            # 0 into a plan of their own: the fields never change
            sl = tuple(slice(0, g) for g in cfg.grid.shape)
            fields = [self.batch.member_coef_field(m) for m in range(self.B)]
            self._A_pads = []
            for g, mesh in enumerate(self.groups):
                shards = []
                for s in mesh.local_shards:
                    glob, loc = shard_slices(cfg, s.origin)
                    a = torch.zeros((self.Bl,) + tuple(cfg.local_shape), dtype=sd)
                    if all(x.stop > 0 for x in loc):
                        for i, m in enumerate(self._group_members(g)):
                            a[i][loc] = torch.from_numpy(
                                np.ascontiguousarray(fields[m][sl][glob])).to(sd)
                    shards.append(a.to(s.device))
                plan = BatchedExchangePlan(mesh, cfg.stencil.bc, 1, sd, self.Bl)
                zero = torch.zeros((self.Bl, 1, 1, 1), dtype=sd,
                                   device=mesh.local_shards[0].device)
                self._A_pads.append(plan.apply(shards, zero))
            dts = [self.batch.member_dt(m) for m in range(self.B)]
            self._DT = self._per_group(dt_factors(dts, cfg.grid.spacing, cd))
            return
        nominal = _solver_taps(cfg)
        self._flat = flat_taps(nominal)
        positions = emission_positions(self._flat)
        member_taps = [self.batch.member_taps(m) for m in range(self.B)]
        self._W = self._per_group(member_weights(member_taps, positions, cd))
        # the Mehrstellen route follows the solo apply's env gate; members
        # share decomposability (same stencil kind, same footprint)
        coeffs = [decompose_mehrstellen(t) for t in member_taps]
        self._mehrstellen = mehrstellen_enabled() and all(c is not None for c in coeffs)
        if self._mehrstellen:
            c = torch.tensor([[compute_weight(x, cd) for x in co] for co in coeffs],
                             dtype=torch.float32).to(cd).reshape(self.B, 3, 1, 1, 1)
            # per group, (a, b, d) each as (B/Pb, 1, 1, 1)
            self._COEF = [tuple(t[:, i] for i in range(3)) for t in self._per_group(c)]

    # ---- the member update (traced binding) ------------------------------

    def _apply(self, g: int, up: torch.Tensor) -> torch.Tensor:
        cd, sd = self.compute_dtype, self.storage_dtype
        if self._mehrstellen:
            return _apply_mehrstellen_padded(up.to(cd), self._COEF[g]).to(sd)
        return apply_taps_padded_params(up, self._flat, self._W[g], compute_dtype=cd,
                                        out_dtype=sd)

    def _step_group(self, g: int, us: List[torch.Tensor]) -> List[torch.Tensor]:
        """One update of group g's members (the parametric mirror of
        ``parallel.step._local_step``): the width-1 batched exchange, the
        chain (or the flux form), the storage padding re-pinned per
        member."""
        cfg, bcv = self.cfg, self._BCV[g]
        shards = self.groups[g].local_shards
        pads = self._plan(g, 1).apply(us, bcv)
        with named_phase(PHASE_STENCIL):
            if self._varcoef:
                from heat3d_tpu_torch.timeint.coeffield import _local_flux_update

                return [_local_flux_update(up, ap, cfg, self._DT[g], s, bc_value=bcv)
                        for s, up, ap in zip(shards, pads, self._A_pads[g])]
            return [_pin_padding(self._apply(g, up), cfg, s, bc_value=bcv)
                    for s, up in zip(shards, pads)]

    def _superstep_group(self, g: int, us: List[torch.Tensor]) -> List[torch.Tensor]:
        """One k-update superstep of group g's members (the mirror of
        ``parallel.step._local_stepk``): the width-k exchange, k chain
        applications with the shrinking ghost rings pinned between them."""
        cfg, k, bcv = self.cfg, self.k, self._BCV[g]
        shards = self.groups[g].local_shards
        pads = self._plan(g, k).apply(us, bcv)
        outs = []
        with named_phase(PHASE_STENCIL):
            for s, cur in zip(shards, pads):
                for j in range(k):
                    cur = self._apply(g, cur)
                    rings = k - 1 - j
                    if rings > 0:
                        cur = _fill_mid_ghosts(cur, cfg, rings, bc_value=bcv, origin=s.origin)
                outs.append(_pin_padding(cur, cfg, s, bc_value=bcv))
        return outs

    def _masked_loop(self, g: int, us, counts: np.ndarray, fn):
        """``fn`` applied ``max(counts)`` times to group g's members; from
        the first trip a member's count is spent, ``torch.where`` keeps its
        field as it was (bitwise frozen) while the rest run on."""
        bound = int(counts.max(initial=0))
        every = int(counts.min(initial=0))
        left = torch.from_numpy(counts.astype(np.int64)).to(
            self.groups[g].local_shards[0].device)
        for i in range(bound):
            new = fn(g, us)
            if i >= every:
                keep = (left > i).reshape(-1, 1, 1, 1)
                new = [torch.where(keep, a, b) for a, b in zip(new, us)]
            us = new
        return us

    # ---- programs ---------------------------------------------------------

    def _build_programs(self) -> None:
        """The baked binding's solo loops, one per member (the traced
        binding runs the methods above)."""
        if self.bind != "baked":
            return
        from heat3d_tpu_torch.parallel.step import (
            PingPong,
            make_exchanges,
            make_multistep_fn,
            make_step_fn,
        )

        cfg, mesh = self.cfg, self.groups[0]
        self._member_cfgs = []
        for m in range(self.B):
            mc = self.batch.member_config(m)
            self._member_cfgs.append(dataclasses.replace(
                cfg, grid=mc.grid, stencil=mc.stencil, run=mc.run, eq_params=mc.eq_params))
        ex = make_exchanges(cfg, mesh)
        pp = PingPong()
        self._member_run = [make_multistep_fn(c, mesh, pingpong=pp, exchanges=ex)
                            for c in self._member_cfgs]
        self._member_step_res = [make_step_fn(c, mesh, with_residual=True, exchanges=ex)
                                 for c in self._member_cfgs]

    # ---- stepping ---------------------------------------------------------

    def _budget_host(self, steps: Union[int, Sequence[int], None]) -> np.ndarray:
        if steps is None:
            return self.budgets
        if np.isscalar(steps) or getattr(steps, "ndim", 1) == 0:
            return np.full((self.B,), int(steps), np.int32)
        b = np.asarray(steps, np.int32)
        if b.shape != (self.B,):
            raise ValueError(
                f"per-member steps must have shape ({self.B},), got "
                f"{b.shape}"
            )
        return b

    def _groups_of(self, u: BatchedField) -> List[List[torch.Tensor]]:
        P = self.cfg.mesh.num_devices
        if not isinstance(u, BatchedField) or len(u.shards) != self.batch_mesh * P:
            raise TypeError(
                f"an ensemble state is a BatchedField of {self.batch_mesh * P} "
                f"shards, got {type(u).__name__}")
        return [list(u.shards[g * P:(g + 1) * P]) for g in range(self.batch_mesh)]

    def _field(self, groups) -> BatchedField:
        return BatchedField([t for us in groups for t in us], self.mesh.shape)

    def _baked_members(self, u: BatchedField, fn) -> Tuple[BatchedField, list]:
        """``fn(m, member shards)`` for every member on the spatial mesh
        (its shard streams tied to the caller's, as ``HeatSolver3D``
        runs), stacked back into the batched layout; returns the stacked
        field and fn's second results."""
        mesh = self.groups[0]
        us = self._groups_of(u)[0]
        outs, extra = [], []
        for m in range(self.B):
            mesh.fork()
            res = fn(m, [t[m].clone() for t in us])
            mesh.join()
            if isinstance(res, tuple):
                res, r = res
                extra.append(r)
            outs.append(res)
        return self._field([[torch.stack([o[i] for o in outs]) for i in range(len(us))]]), extra

    def run(self, u: BatchedField, steps: Union[int, Sequence[int], None] = None) -> BatchedField:
        """Advance every member by its budget. ``steps``: a scalar (all
        members), a per-member sequence, or ``None`` (each scenario's own
        budget). Members advance through supersteps for ``budget // k``
        then single steps for the remainder — the exact update sequence a
        solo run of that budget executes; finished members freeze bitwise
        while the rest run on."""
        budgets = self._budget_host(steps)
        if self.bind == "baked":
            return self._baked_members(
                u, lambda m, us: self._member_run[m](us, int(budgets[m])))[0]
        k = self.k
        out = []
        with named_phase(PHASE_STEP):
            for g, us in enumerate(self._groups_of(u)):
                b = budgets[self._group_members(g).start:self._group_members(g).stop]
                if k > 1:
                    us = self._masked_loop(g, us, b // k, self._superstep_group)
                    us = self._masked_loop(g, us, b % k, self._step_group)
                else:
                    us = self._masked_loop(g, us, b, self._step_group)
                out.append(us)
        return self._field(out)

    def step_with_residual(self, u: BatchedField):
        """One update for every member; returns ``(u_new, r2)`` where
        ``r2`` is the ENSEMBLE-AGGREGATE residual sum-of-squares (a 0-d
        tensor — the supervised loop's convergence/health number; use
        :meth:`step_with_member_residuals` for per-member values)."""
        u, r = self.step_with_member_residuals(u)
        return u, r.sum()

    def step_with_member_residuals(self, u: BatchedField):
        """One update for every member; returns ``(u_new, r2_members)``,
        ``r2_members`` a (B,) tensor on the first shard's device: each
        member's residual sum-of-squares, reduced on its own (nx, ny, nz)
        view shard by shard and the partials summed in shard order, as a
        solo run sums them (so independent of the packing)."""
        res_dtype = getattr(torch, self.cfg.precision.residual)
        if self.bind == "baked":
            new, rs = self._baked_members(u, lambda m, us: self._member_step_res[m](us))
            return new, torch.stack([r.reshape(()).to(self.device) for r in rs])
        out, rs = [], []
        with named_phase(PHASE_STEP):
            for g, us in enumerate(self._groups_of(u)):
                new = self._step_group(g, us)
                with named_phase("residual"):
                    for i in range(self.Bl):
                        total = None
                        for a, b in zip(new, us):
                            p = residual_sumsq(a[i], b[i], res_dtype).to(self.device)
                            total = p if total is None else total + p
                        rs.append(total)
                out.append(new)
        return self._field(out), torch.stack(rs)

    # ---- state ------------------------------------------------------------

    def init_state(self, init=None) -> BatchedField:
        """The batched initial field. ``init`` None or ``"scenario"``
        builds each member's own IC from its scenario spec (named
        initializers through ``core.golden.make_init_block`` on each
        shard's clipped global slices, float32 then rounded to storage,
        as ``HeatSolver3D`` builds them; an array of the grid shape as
        given); a string or array overrides every member (the supervised
        restart). Storage padding holds each member's bc value."""
        with obs.get().span(
            "init_state",
            init="scenario" if init in (None, "scenario") else (
                init if isinstance(init, str) else "array"
            ),
            grid=list(self.cfg.grid.shape),
            members=self.B,
        ):
            return self._from_member_blocks(init)

    def _member_block(self, m: int, glob, init_override, cache: dict) -> torch.Tensor:
        true_shape = self.cfg.grid.shape
        init = init_override
        if init in (None, "scenario"):
            init = self.batch.members[m].init
        if isinstance(init, np.ndarray):
            if init.shape != true_shape:
                raise ValueError(
                    f"scenario {m}: init shape {init.shape} != grid "
                    f"{true_shape}"
                )
            return torch.from_numpy(np.array(init[glob]))
        seed = self.batch.members[m].seed if init == "random" else 0
        key = (init, seed, glob)
        if key not in cache:
            cache[key] = torch.from_numpy(
                golden.make_init_block(init, true_shape, glob, seed=seed))
        return cache[key]

    def _from_member_blocks(self, init_override=None) -> BatchedField:
        cfg, sd = self.cfg, self.storage_dtype
        cache: dict = {}
        groups = []
        for g, mesh in enumerate(self.groups):
            us = []
            for s in mesh.local_shards:
                glob, loc = shard_slices(cfg, s.origin)
                t = torch.empty((self.Bl,) + tuple(cfg.local_shape), dtype=sd)
                for i, m in enumerate(self._group_members(g)):
                    # uneven-decomposition padding pins at the MEMBER's bc
                    t[i].fill_(float(self.batch.members[m].bc_value))
                    if all(x.stop > 0 for x in loc):
                        t[i][loc] = self._member_block(m, glob, init_override, cache).to(sd)
                us.append(t.to(s.device))
            groups.append(us)
        return self._field(groups)

    def zeros_state(self) -> BatchedField:
        """All-zero TRUE grids (padding at each member's bc)."""
        return self._from_member_blocks(np.zeros(self.cfg.grid.shape, np.float32))

    # ---- IO ---------------------------------------------------------------

    def gather(self, u: BatchedField) -> np.ndarray:
        """All member fields on the host, (B, *grid), storage padding
        stripped; bf16 storage comes back as float32 (exactly)."""
        cfg = self.cfg
        full = None
        for slot, t in zip(self.mesh.local_shards, u.shards):
            block = (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy()
            if full is None:
                full = np.empty((self.B,) + tuple(cfg.padded_shape), dtype=block.dtype)
            full[tuple(slice(o, o + n) for o, n in zip(slot.origin, block.shape))] = block
        want = (self.B,) + tuple(cfg.grid.shape)
        if full.shape != want:
            full = full[(slice(None),) + tuple(slice(0, g) for g in cfg.grid.shape)]
        return full

    def save_checkpoint(self, path: str, u: BatchedField, step: int) -> None:
        """The JAX package's checkpoint format over the (B, *padded)
        field: one ``shard_<b>_<x>_<y>_<z>.npy`` a shard."""
        ckpt.save(path, u, step, extra={"config": repr(self.cfg), "members": self.B})

    def load_checkpoint(self, path: str) -> Tuple[BatchedField, int]:
        shape = tuple(ckpt.load_manifest(path)["global_shape"])
        want = (self.B,) + tuple(self.cfg.padded_shape)
        if shape != want:
            raise ValueError(
                f"checkpoint {path} holds a {shape} field but this "
                f"ensemble's storage shape is {want} (B={self.B}, grid "
                f"{self.cfg.grid.shape} on mesh {self.cfg.mesh.shape}) — "
                "wrong checkpoint for this batch"
            )
        u, step, _ = ckpt.load(path, self.mesh)
        shards = [u] if isinstance(u, torch.Tensor) else list(u.shards)
        shards = [t.to(self.storage_dtype) for t in shards]
        return BatchedField(shards, self.mesh.shape), step

    def run_supervised(
        self,
        total_steps: int,
        ckpt_root: str,
        checkpoint_every: int = 0,
        **kwargs,
    ):
        """Run the whole ensemble to global step ``total_steps`` under the
        resilience supervisor — generations carry the batch axis, so a
        supervised ensemble heals exactly like a single run. The ensemble
        advances in LOCKSTEP here (``total_steps`` for every member);
        per-member budgets are a :meth:`run` feature."""
        from heat3d_tpu_torch.resilience.supervisor import run_supervised

        device = self._placement
        kwargs.setdefault(
            "make_solver",
            lambda: EnsembleSolver(self.batch, batch_mesh=self.batch_mesh,
                                   bind=self.bind, device=device),
        )
        kwargs.setdefault("init", "scenario")
        kwargs.setdefault("want_platform", self.device.type)
        return run_supervised(self, total_steps, ckpt_root, checkpoint_every, **kwargs)

"""Configuration for the PyTorch/CUDA port of the 3D heat-equation framework.

A copy of ``heat3d_tpu.core.config``: the same dataclasses and the same
validation, so one config means the same run in both packages. The one
addition is :func:`check_ported`, which ``SolverConfig`` calls last and which
rejects, with a "not ported yet" ValueError, every knob value whose route
the port does not have yet (see ROADMAP.md for the queue).

Reference parity (SURVEY.md §5 "Config / flag system"): the reference class
parses positional argv in main() — global grid dims, iteration count,
process-grid dims — and carries the parallelism config via ``mpirun -np``.
Here every judged config from BASELINE.json is expressible as a frozen
dataclass (and via the CLI front-end in ``heat3d_tpu.cli``):

  1. 128^3, 7-point, single-rank golden reference   -> GridConfig(128), StencilConfig('7pt'), MeshConfig((1,1,1))
  2. 1024^3, 7-point, 1D slab on v5p-8              -> MeshConfig((8,1,1))
  3. 2048^3, 7-point, 3D block (2x2x2) on v5p-8     -> MeshConfig((2,2,2))
  4. 4096^3, 27-point, 3D block on v5p-64           -> StencilConfig('27pt'), MeshConfig((4,4,4))
  5. 4096^3, bf16 stencil + fp32 residual, v5p-128  -> Precision(compute='bfloat16', residual='float32')
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class BoundaryCondition(enum.Enum):
    """Boundary handling at the global domain faces.

    DIRICHLET: ghost cells hold a fixed value (default 0.0) — the canonical
      heat-equation setup in the reference class (SURVEY.md §2 C8).
    PERIODIC: ghost cells wrap around the torus — maps onto ppermute rings
      with full wrap pairs (SURVEY.md §2 C3: "periodic vs non-periodic
      boundary = ppermute ring vs shifted-edge masking").
    """

    DIRICHLET = "dirichlet"
    PERIODIC = "periodic"


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Global grid: interior cell counts, physical spacing, diffusivity.

    ``shape`` counts interior (updated) cells; ghost layers are not included
    (the reference allocates (nx+2)(ny+2)(nz+2) with ghosts — SURVEY.md §1 L0).
    """

    shape: Tuple[int, int, int]
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    alpha: float = 1.0  # thermal diffusivity
    dt: Optional[float] = None  # None -> stable_dt() * 0.9

    def __post_init__(self):
        if len(self.shape) != 3 or any(s < 1 for s in self.shape):
            raise ValueError(f"shape must be 3 positive ints, got {self.shape}")
        if any(h <= 0 for h in self.spacing):
            raise ValueError(f"spacing must be positive, got {self.spacing}")

    @staticmethod
    def cube(n: int, **kw) -> "GridConfig":
        return GridConfig(shape=(n, n, n), **kw)

    def stable_dt(self) -> float:
        """Forward-Euler stability bound for the 3D diffusion operator:
        dt <= 1 / (2*alpha*(1/hx^2 + 1/hy^2 + 1/hz^2))."""
        hx, hy, hz = self.spacing
        return 1.0 / (2.0 * self.alpha * (1.0 / hx**2 + 1.0 / hy**2 + 1.0 / hz**2))

    def effective_dt(self) -> float:
        return self.dt if self.dt is not None else 0.9 * self.stable_dt()

    @property
    def num_cells(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]


@dataclasses.dataclass(frozen=True)
class StencilConfig:
    """Which finite-difference stencil to apply.

    ``kind`` selects a named member of ``core.stencils.STENCILS``:
      '7pt'  — 2nd-order 7-point Laplacian (the reference's CUDA kernel,
               SURVEY.md §2 C1).
      '27pt' — isotropic 27-point Laplacian (judged config 4; needs
               edge+corner ghost data, hence axis-ordered halo exchange).
    """

    kind: str = "7pt"
    bc: BoundaryCondition = BoundaryCondition.DIRICHLET
    bc_value: float = 0.0

    def __post_init__(self):
        from heat3d_tpu_torch.core.stencils import STENCILS

        if self.kind not in STENCILS:
            raise ValueError(f"unknown stencil {self.kind!r}; have {sorted(STENCILS)}")


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy (judged config 5: bf16 stencil + fp32 residual).

    ``storage``  — dtype the field is held in (HBM traffic is proportional).
    ``compute``  — dtype the stencil math runs in inside the kernel.
    ``residual`` — dtype the global residual norm accumulates in; fp32
                   regardless of storage per BASELINE.json config 5.
    """

    storage: str = "float32"
    compute: str = "float32"
    residual: str = "float32"

    @staticmethod
    def fp32() -> "Precision":
        return Precision()

    @staticmethod
    def bf16() -> "Precision":
        return Precision(storage="bfloat16", compute="float32", residual="float32")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The Cartesian process/device topology — the MPI_Cart_create analogue.

    ``shape`` = (Px, Py, Pz) device-mesh extents; total devices Px*Py*Pz.
    Covers 1D slab (P,1,1) through full 3D block decomposition
    (BASELINE.json configs 2-4; SURVEY.md §2 C3/C13). ``axis_names`` are the
    jax.sharding.Mesh axis names used by every collective.
    """

    shape: Tuple[int, int, int] = (1, 1, 1)
    axis_names: Tuple[str, str, str] = ("x", "y", "z")

    def __post_init__(self):
        if len(self.shape) != 3 or any(p < 1 for p in self.shape):
            raise ValueError(f"mesh shape must be 3 positive ints, got {self.shape}")

    @property
    def num_devices(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]

    @staticmethod
    def slab(p: int) -> "MeshConfig":
        return MeshConfig(shape=(p, 1, 1))

    @staticmethod
    def for_devices(n: int) -> "MeshConfig":
        """Balanced 3D factorization of n devices — the MPI_Dims_create
        analogue (SURVEY.md §2 C3)."""
        return MeshConfig(shape=dims_create(n))


def dims_create(n: int) -> Tuple[int, int, int]:
    """Factor n into a near-cubic (Px, Py, Pz), largest first — mirrors the
    behavior of MPI_Dims_create(n, 3, dims) (SURVEY.md §2 C3)."""
    if n < 1:
        raise ValueError("need n >= 1")
    best = (n, 1, 1)
    best_score = None
    for px in range(1, n + 1):
        if n % px:
            continue
        m = n // px
        for py in range(1, m + 1):
            if m % py:
                continue
            pz = m // py
            dims = tuple(sorted((px, py, pz), reverse=True))
            score = max(dims) - min(dims)
            if best_score is None or score < best_score:
                best, best_score = dims, score
    return best  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Driver options: iteration count, residual cadence, reporting.

    Mirrors the reference main()'s argv (iters, check toggles) — SURVEY.md §2 C4.
    """

    num_steps: int = 100
    residual_every: int = 0  # 0 = never (benchmark mode: no mid-loop syncs)
    tolerance: Optional[float] = None  # convergence target; None = fixed steps
    seed: int = 0
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    log_every: int = 0
    profile_dir: Optional[str] = None  # jax.profiler trace output


# The time-integrator registry names (heat3d_tpu.timeint mirrors this
# tuple; docs/INTEGRATORS.md). A module constant rather than a lazy
# import: config validation must not depend on the timeint package
# importing cleanly.
INTEGRATORS: Tuple[str, ...] = ("explicit-euler", "leapfrog", "implicit-cg")
DEFAULT_INTEGRATOR = "explicit-euler"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Everything needed to build a solver — the full judged-config surface."""

    grid: GridConfig
    stencil: StencilConfig = StencilConfig()
    mesh: MeshConfig = MeshConfig()
    precision: Precision = Precision()
    run: RunConfig = RunConfig()
    backend: str = "auto"  # 'jnp' | 'pallas' | 'conv' | 'auto' (pallas on TPU else jnp)
    # Split each step into interior + boundary-shell updates so XLA's async
    # collectives overlap the halo ppermutes with the interior sweep — the
    # TPU analogue of the reference class's two-stream interior/boundary
    # overlap (SURVEY.md §3.2, §7.3 item 2). Needs local blocks >= 3 per axis.
    overlap: bool = False
    # Ghost-exchange transport: 'ppermute' (XLA collective-permute, v1),
    # 'dma' (Pallas make_async_remote_copy kernels — the CUDA-aware/GPUDirect
    # analogue, SURVEY.md §7.1 item 7; TPU only), or 'auto' (resolve
    # through the tuning cache — heat3d_tpu.tune — with a 'ppermute'
    # static fallback when no cache entry matches; docs/TUNING.md).
    halo: str = "ppermute"
    # Updates per ghost exchange in the fixed-step loop (temporal blocking):
    # k > 1 exchanges width-k halos and applies the stencil k times per
    # superstep, cutting ICI messages k-fold; for 2 <= k <= 4 on TPU the k
    # applications additionally fuse into ONE HBM sweep via a Pallas
    # kernel (the no-padded-copy direct2 kernel where its k=2 scope
    # applies, else the k-sweep streaming kernel with shrinking ghost
    # rings resident in VMEM).
    # Deeper k pays growing redundant ring recompute — bench rows carry
    # `cost_redundant_flops_frac` so that trade is measured, not assumed
    # (docs/TUNING.md "Deep temporal blocking"). k == 0 means "auto":
    # resolve through the tuning cache (static fallback 1). The superstep
    # needs local extents >= max(3, k) (validated at step-build time).
    time_blocking: int = 1
    # Halo-exchange ordering: 'axis' (x -> y -> z, each axis operating on
    # the array already padded by previous axes — propagates edge/corner
    # ghosts, required by the 27-point stencil) or 'pairwise' (all six
    # face ppermutes issued concurrently from the RAW boundary faces; no
    # cross-axis data dependence, so a cross-host start skew of one
    # exchange latency cannot serialize the axes — the stagger-tolerant
    # ordering, ROADMAP "skew-aware halo tuning"). Pairwise fills corner
    # ghosts with the BC value, so it is only valid for stencils that
    # never read them (7pt) at time_blocking <= 1 on the ppermute
    # transport; the tuner A/Bs the two orderings.
    halo_order: str = "axis"
    # Exchange-plan mode (heat3d_tpu.parallel.plan; docs/TUNING.md):
    # 'monolithic' (one collective per face — the classic structure,
    # permutations and slices precomputed once per run by the persistent
    # ExchangePlan), 'partitioned' (each face ships as sub-blocks, every
    # sub-block its own ppermute issued from its own boundary strip —
    # the early-bird ordering of the persistent/partitioned-MPI stencil
    # literature; assembled ghosts are bitwise-identical to monolithic,
    # so it is valid on every stencil/ordering/decomposition, but it
    # pins the exchange path — the in-kernel ghost-synthesis routes
    # stand down — and requires the ppermute transport), or 'auto'
    # (resolve through the tuning cache, static fallback monolithic).
    halo_plan: str = "monolithic"
    # Fused in-kernel RDMA superstep (ops/stencil_fused_rdma;
    # docs/TUNING.md): 'on' dispatches the single Pallas kernel that
    # starts the x-face remote copies itself (per-sub-block descriptors
    # riding the ExchangePlan schedule — halo_plan='partitioned' splits
    # the sends), sweeps the interior while they fly, then finishes the
    # skin planes — the paper's compute/comm overlap done inside ONE
    # kernel, without the 'dma'-transport exchange phase. Scope: x-slab
    # meshes, time_blocking <= 2, axis ordering; outside the scope the
    # route stands down and the plan-driven jnp path runs (values
    # identical). 'auto' resolves through the tuning cache (static
    # fallback 'off').
    fused_rdma: str = "off"
    # Equation family (heat3d_tpu.eqn registry; docs/EQUATIONS.md):
    # which PDE the tap compiler lowers onto the stencil footprint.
    # 'heat' is the legacy hardcoded path, now spec-authored — its
    # lowered taps are bit-identical to stencil_taps by construction.
    # The family + eq_params select the OPERATOR; stencil.kind stays the
    # footprint/accuracy knob (families declare which kinds they
    # support), and everything downstream of the taps (halo plans,
    # supersteps, tuner, serve, IR certification) is equation-agnostic.
    equation: str = "heat"
    # Family parameter overrides as (name, value) pairs — hashable, so
    # configs stay usable as dict keys. Unknown names fail validation;
    # unset names take the family defaults (heat3d eqn show FAMILY).
    eq_params: Tuple[Tuple[str, float], ...] = ()
    # Time integrator (heat3d_tpu.timeint registry; docs/INTEGRATORS.md):
    # 'explicit-euler' — the legacy single-level forward-Euler carry (the
    # bit-identical default; every pre-timeint config reads unchanged);
    # 'leapfrog' — two-level (u, u_prev) carry for the second-order-in-
    # time wave family; 'implicit-cg' — backward Euler via a matrix-free
    # conjugate-gradient solve (keep-masked, pmax-bounded SPMD-uniform
    # loop), opening dt regimes the explicit CFL bound forbids.
    # Integrator/family coupling (wave <-> leapfrog, CG needs a symmetric
    # operator) is validated with the equation below.
    integrator: str = DEFAULT_INTEGRATOR

    def __post_init__(self):
        if not isinstance(self.eq_params, tuple):
            # normalize list-of-pairs input (CLI/json surfaces) to the
            # hashable canonical form
            object.__setattr__(
                self,
                "eq_params",
                tuple((str(k), float(v)) for k, v in self.eq_params),
            )
        if self.halo not in ("ppermute", "dma", "auto"):
            raise ValueError(f"unknown halo transport {self.halo!r}")
        if self.time_blocking < 0:
            raise ValueError(
                f"time_blocking must be >= 1 (or 0 = auto via the tuning "
                f"cache), got {self.time_blocking}"
            )
        if self.halo_order not in ("axis", "pairwise"):
            raise ValueError(
                f"unknown halo_order {self.halo_order!r} (want axis|pairwise)"
            )
        if self.halo_plan not in ("monolithic", "partitioned", "auto"):
            raise ValueError(
                f"unknown halo_plan {self.halo_plan!r} "
                "(want monolithic|partitioned|auto)"
            )
        if self.halo_plan == "partitioned" and self.halo == "dma":
            raise ValueError(
                "halo_plan='partitioned' applies to the ppermute "
                "transport; the DMA slab exchange kernels ship whole "
                "faces by construction — use halo='ppermute' (or plan "
                "mode 'monolithic')"
            )
        if self.fused_rdma not in ("off", "on", "auto"):
            raise ValueError(
                f"unknown fused_rdma {self.fused_rdma!r} (want off|on|auto)"
            )
        if self.fused_rdma == "on":
            # the fused superstep IS the exchange: it rides the
            # ExchangePlan's axis-ordered ppermute-transport schedule, so
            # the knobs that select a different exchange path conflict
            # rather than compose
            if self.halo == "dma":
                raise ValueError(
                    "fused_rdma='on' drives its own remote copies from "
                    "the ExchangePlan schedule; the 'dma' exchange "
                    "transport is a different path — use halo='ppermute'"
                )
            if self.overlap:
                raise ValueError(
                    "fused_rdma='on' and overlap are mutually exclusive: "
                    "the fused kernel already overlaps the transfers "
                    "with the interior sweep"
                )
            if self.halo_order == "pairwise":
                raise ValueError(
                    "fused_rdma='on' rides the plan's axis-ordered "
                    "schedule; halo_order='pairwise' is a different "
                    "exchange structure"
                )
            if self.time_blocking not in (0, 1, 2):
                raise ValueError(
                    "fused_rdma='on' composes with temporal blocking "
                    f"k <= 2, got time_blocking={self.time_blocking}"
                )
            if self.backend == "conv":
                raise ValueError(
                    "fused_rdma='on' is a Pallas route; backend='conv' "
                    "cannot host it"
                )
        if self.halo_order == "pairwise":
            # pairwise ordering leaves corner/edge ghosts at bc_value:
            # exactly the cells the 27pt stencil and the temporally-blocked
            # ring recompute read — reject instead of silently corrupting
            if self.stencil.kind != "7pt":
                raise ValueError(
                    f"halo_order='pairwise' needs a face-only stencil "
                    f"(7pt); {self.stencil.kind} reads the corner ghosts "
                    "only axis-ordered exchange propagates"
                )
            if self.time_blocking not in (0, 1):
                raise ValueError(
                    "halo_order='pairwise' needs time_blocking <= 1: the "
                    "superstep's shrinking ghost rings read edge cells "
                    "only axis-ordered exchange fills"
                )
            if self.halo == "dma":
                raise ValueError(
                    "halo_order='pairwise' applies to the ppermute "
                    "transport; the DMA exchange kernels implement "
                    "axis-ordered propagation"
                )
        if self.integrator not in INTEGRATORS:
            raise ValueError(
                f"unknown integrator {self.integrator!r} "
                f"(want {'|'.join(INTEGRATORS)})"
            )
        # equation-family validation (unknown family/params, unsupported
        # stencil kind, integrator/family coupling) — lazy import like
        # StencilConfig's STENCILS check
        from heat3d_tpu_torch import eqn

        eqn.validate_config(self)
        if self.is_padded and self.stencil.bc is BoundaryCondition.PERIODIC:
            raise ValueError(
                f"grid {self.grid.shape} is not divisible by mesh "
                f"{self.mesh.shape}: uneven decompositions are handled by "
                "bc-value padding, which breaks periodic wrap adjacency — "
                "use a divisible grid/mesh for periodic BCs "
                "(SURVEY.md §7.3 item 4)"
            )
        check_ported(self)

    @property
    def padded_shape(self) -> Tuple[int, int, int]:
        """Storage shape: the grid rounded up per axis to a mesh multiple.
        Cells beyond ``grid.shape`` are inert padding pinned at bc_value,
        which reproduces Dirichlet ghost semantics at the true boundary
        (SURVEY.md §7.3 item 4; the reference class restricts itself to
        divisible extents instead)."""
        return tuple(  # type: ignore[return-value]
            -(-g // p) * p for g, p in zip(self.grid.shape, self.mesh.shape)
        )

    @property
    def is_padded(self) -> bool:
        return self.padded_shape != self.grid.shape

    @property
    def local_shape(self) -> Tuple[int, int, int]:
        return tuple(  # type: ignore[return-value]
            s // p for s, p in zip(self.padded_shape, self.mesh.shape)
        )


def _unported(what: str) -> ValueError:
    return ValueError(
        f"{what} is not ported yet: the PyTorch/CUDA port runs the "
        "explicit-Euler solve over any mesh of shards (halo ppermute|dma, "
        "halo_plan monolithic|partitioned, fused_rdma off|on, overlap, "
        "time_blocking k >= 1, backend auto|pallas|jnp|conv, float32 or "
        "bfloat16 storage and compute) through its direct, exchange-path "
        "(stream, streamk), DMA halo and fused exchange-and-sweep kernels"
    )


def check_ported(cfg: "SolverConfig") -> None:
    """Reject every config this port cannot run yet, naming the knob.

    The JAX package resolves the ``auto`` knobs (``time_blocking=0``,
    ``halo``, ``halo_plan`` and ``fused_rdma`` 'auto') through its tuning
    cache; the port has no tuning cache yet, so those are rejected too.
    ``backend='auto'`` needs no cache: it always takes the kernels. Any
    mesh is ported, with uneven (bc-padded) Dirichlet grids; uneven
    periodic grids are rejected above, as in the JAX package."""
    if cfg.halo not in ("ppermute", "dma"):
        raise _unported(f"halo={cfg.halo!r}")
    if cfg.fused_rdma not in ("off", "on"):
        raise _unported(f"fused_rdma={cfg.fused_rdma!r}")
    if cfg.halo_plan not in ("monolithic", "partitioned"):
        raise _unported(f"halo_plan={cfg.halo_plan!r}")
    if cfg.halo_order != "axis":
        raise _unported(f"halo_order={cfg.halo_order!r}")
    if cfg.time_blocking < 1:
        raise _unported(f"time_blocking={cfg.time_blocking} (auto)")
    if cfg.integrator != DEFAULT_INTEGRATOR:
        raise _unported(f"integrator={cfg.integrator!r}")
    if cfg.backend not in ("auto", "pallas", "jnp", "conv"):
        raise _unported(f"backend={cfg.backend!r}")
    if cfg.precision.compute not in ("float32", "bfloat16"):
        raise _unported(f"compute dtype {cfg.precision.compute!r}")
    if cfg.precision.storage not in ("float32", "bfloat16"):
        raise _unported(f"storage dtype {cfg.precision.storage!r}")

"""The search space: a declarative knob lattice over ``SolverConfig``
with validity pruning, and the mesh factorizations the elastic re-plan of
a supervised run needs (``resilience.elastic``).

Port of ``heat3d_tpu.tune.space``: :data:`DEFAULT_KNOBS` (the same lattice
values), :func:`parse_knob_values`, :func:`check_concrete`,
:func:`knob_label`, :class:`Candidate`, :func:`enumerate_candidates`,
:func:`mesh_candidates`, :func:`apply_knobs`, :func:`survivor_candidates`
and :func:`prune_reason`. A candidate is ``base config + knob overrides``.
Pruning reuses the port's OWN validation instead of a parallel rule set
that would drift: ``SolverConfig.__post_init__`` (with ``check_ported``)
rejects structurally invalid combos, and :func:`prune_reason` builds the
port's solver and its fixed-step loop, so every route gate a real run
would hit raises the same ``ValueError`` here. A solver build allocates
no field (the plans' padded blocks come with the first step), and each
candidate's solver is released before the next is built.

One difference from the JAX lattice: the JAX package prunes every
``halo='dma'`` candidate off the TPU (its DMA kernels run only there). The
port's DMA transport runs on the card, and on the CPU through the kernels'
plain versions, so its ``dma`` candidates are pruned only by the gates
they share with ``ppermute`` (plan mode, ordering, overlap scope).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from heat3d_tpu_torch.core.config import MeshConfig, SolverConfig, dims_create

# The default knob lattice (the JAX package's values). `mesh` is absent:
# factorization candidates depend on the device count (mesh_candidates)
# and default to "don't search" — an explicit topology is the operator's
# call.
DEFAULT_KNOBS: Dict[str, Tuple[Any, ...]] = {
    "backend": ("jnp", "pallas", "conv"),
    "halo": ("ppermute", "dma"),
    "overlap": (False, True),
    # tb=2 takes the direct2 kernel, 3..4 the width-k exchange and streamk;
    # undersized local extents and pairwise+deep-tb combos are pruned by
    # the production validation (prune_reason builds the real superstep).
    # The measured winner already pays the ring recompute.
    "time_blocking": (1, 2, 3, 4),
    "halo_order": ("axis", "pairwise"),
    # partitioned = each face copied as sub-blocks (more, smaller copies;
    # pins the exchange path); value-identical to monolithic, so the A/B
    # is a transport-schedule measurement. dma+partitioned is
    # config-rejected and pruned.
    "halo_plan": ("monolithic", "partitioned"),
    # the fused RDMA kernels (x-face pushes inside the sweep); dma,
    # overlap, pairwise and deep-tb combos are config-rejected and pruned
    "fused_rdma": ("off", "on"),
}

# knob-value parsers for CLI `--knob name=v1,v2` strings
_BOOL = {"0": False, "false": False, "1": True, "true": True}


def parse_knob_values(name: str, spec: str) -> Tuple[Any, ...]:
    """Parse a CLI value list for ``name``: ``overlap=0,1``,
    ``time_blocking=1,2``, ``mesh=8x1x1,2x2x2``, ``halo=ppermute,dma``."""
    vals: List[Any] = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if name == "overlap":
            try:
                vals.append(_BOOL[tok.lower()])
            except KeyError:
                raise ValueError(
                    f"overlap value {tok!r} (want 0/1/true/false)"
                ) from None
        elif name == "time_blocking":
            k = int(tok)
            if k < 1:
                raise ValueError(
                    "searched time_blocking values must be concrete "
                    "(>= 1): 0 means 'resolve through the cache this "
                    "search is about to write'"
                )
            vals.append(k)
        elif name == "mesh":
            dims = tuple(int(x) for x in tok.lower().split("x"))
            if len(dims) != 3:
                raise ValueError(f"mesh value {tok!r} (want PxQxR)")
            vals.append(dims)
        else:
            if name in ("halo", "halo_plan", "fused_rdma") and tok == "auto":
                raise ValueError(
                    f"searched {name} values must be concrete: 'auto' "
                    "means 'resolve through the cache this search is "
                    "about to write'"
                )
            vals.append(tok)
    if not vals:
        raise ValueError(f"no values for knob {name!r}")
    return tuple(vals)


def check_concrete(space: Dict[str, Sequence[Any]]) -> None:
    """Reject non-concrete knob values in a programmatic search space
    (``time_blocking`` 0, ``halo`` 'auto'): a trial measuring 'auto'
    would measure whatever the static fallback runs while labeling the
    row with the sentinel, and cache an entry resolution must reject."""
    for name, values in space.items():
        for v in values:
            if (name == "time_blocking" and isinstance(v, int) and v < 1) or (
                name in ("halo", "halo_plan", "fused_rdma") and v == "auto"
            ):
                raise ValueError(
                    f"search space knob {name}={v!r} is not concrete — "
                    "auto sentinels cannot be measured as candidates"
                )


def mesh_candidates(num_devices: int) -> Tuple[Tuple[int, int, int], ...]:
    """Distinct factorization candidates for ``num_devices``: the 1D
    x-slab (the reference's default), the balanced 3D block
    (MPI_Dims_create analogue), and the 2D pencil between them."""
    out = [(num_devices, 1, 1), dims_create(num_devices)]
    for px in range(2, num_devices + 1):
        if num_devices % px == 0:
            out.append((px, num_devices // px, 1))
            break
    seen: List[Tuple[int, int, int]] = []
    for m in out:
        if m not in seen:
            seen.append(m)
    return tuple(seen)


def apply_knobs(base: SolverConfig, knobs: Dict[str, Any]) -> SolverConfig:
    """``base`` with ``knobs`` overridden (``mesh`` takes a (Px,Py,Pz)
    tuple). Raises ``ValueError`` for structurally invalid combos —
    ``SolverConfig.__post_init__`` is the single source of those rules."""
    kw: Dict[str, Any] = {}
    for k, v in knobs.items():
        if k == "mesh":
            kw["mesh"] = MeshConfig(shape=tuple(v))
        else:
            kw[k] = v
    return dataclasses.replace(base, **kw)


def survivor_candidates(
    base: SolverConfig,
    num_devices: int,
    validate: bool = True,
    make_solver: Optional[Callable[[SolverConfig], object]] = None,
) -> List[SolverConfig]:
    """Certified degraded configs for ``base`` over ``num_devices``
    surviving devices, slab-first (:func:`mesh_candidates`), each passing
    three production gates so a degraded run only ever lands on a config a
    normal run could have used:

    - ``SolverConfig.__post_init__`` (structural validity, ported routes);
    - the **re-stitch contract**: the candidate's ``padded_shape`` equals
      ``base``'s, because the checkpoint being stitched onto the survivor
      mesh was saved in ``base``'s storage shape
      (``HeatSolver3D.load_checkpoint`` rejects another);
    - :func:`prune_reason` building the real solver with ``make_solver``
      (the run's factory, so the candidate is built where the run's
      shards live), unless ``validate`` is False.
    """
    out: List[SolverConfig] = []
    if num_devices < 1:
        return out
    for m in mesh_candidates(num_devices):
        try:
            cfg = apply_knobs(base, {"mesh": m})
        except ValueError:
            continue
        if cfg.padded_shape != base.padded_shape:
            continue
        if validate and prune_reason(cfg, make_solver) is not None:
            continue
        out.append(cfg)
    return out


def prune_reason(
    cfg: SolverConfig,
    make_solver: Optional[Callable[[SolverConfig], object]] = None,
) -> Optional[str]:
    """Why ``cfg`` cannot run in the CURRENT environment, or None.

    Builds the solver (``make_solver(cfg)``, default ``HeatSolver3D(cfg)``)
    and its fixed-step loop, so the gates are the production gates: routes,
    transports, time-blocking constraints, device availability. The solver
    is dropped before returning."""
    if make_solver is None:
        from heat3d_tpu_torch.models.heat3d import HeatSolver3D

        make_solver = HeatSolver3D
    try:
        solver = make_solver(cfg)
        # the superstep's constraints are checked on first use of the
        # fixed-step loop: force them now
        solver._multistep  # noqa: B018 - building IS the validation
    except (ValueError, NotImplementedError, ImportError) as e:
        return f"{type(e).__name__}: {str(e)[:160]}"
    del solver
    return None


def knob_label(base: SolverConfig, space: Dict[str, Sequence[Any]],
               overrides: Dict[str, Any]) -> Dict[str, str]:
    """The FULL knob assignment of a candidate as strings (base values
    fill the knobs not overridden) — the shape ``tune.decide.pair_rows``
    pairs on, so every searched knob appears in every label."""
    label: Dict[str, str] = {}
    for name in space:
        if name in overrides:
            v = overrides[name]
        elif name == "mesh":
            v = base.mesh.shape
        else:
            v = getattr(base, name)
        if name == "mesh":
            v = "x".join(str(x) for x in v)
        elif isinstance(v, bool):
            v = int(v)
        label[name] = str(v)
    return label


@dataclasses.dataclass(frozen=True)
class Candidate:
    knobs: Dict[str, str]  # full stringified knob assignment (the label)
    overrides: Dict[str, Any]  # the raw knob overrides applied to base
    cfg: Optional[SolverConfig]  # None when construction itself failed
    prune: Optional[str]  # why it was pruned, or None = measurable


def enumerate_candidates(
    base: SolverConfig,
    space: Optional[Dict[str, Sequence[Any]]] = None,
    validate: bool = True,
    make_solver: Optional[Callable[[SolverConfig], object]] = None,
) -> List[Candidate]:
    """The pruned candidate list for ``base`` over ``space`` (default
    :data:`DEFAULT_KNOBS`), each built with ``make_solver`` (the search's
    factory: where its trials' shards live). The FIRST candidate is
    always ``base`` itself (the static default — the speedup-vs-default
    reference, pruned only if it genuinely cannot run). Duplicates
    (overrides reproducing the base config) are dropped."""
    space = dict(space if space is not None else DEFAULT_KNOBS)
    check_concrete(space)
    names = list(space)
    out: List[Candidate] = []
    seen: set = set()

    def add(overrides: Dict[str, Any]) -> None:
        label = knob_label(base, space, overrides)
        try:
            cfg = apply_knobs(base, overrides)
        except ValueError as e:
            out.append(
                Candidate(label, overrides, None, f"invalid: {str(e)[:160]}")
            )
            return
        if cfg in seen:
            return
        seen.add(cfg)
        reason = prune_reason(cfg, make_solver) if validate else None
        out.append(Candidate(label, overrides, cfg, reason))

    add({})  # the static default rides first
    for values in itertools.product(*(space[n] for n in names)):
        add(dict(zip(names, values)))
    return out

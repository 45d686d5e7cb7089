"""The tuning cache: measured winning configs, keyed by what determines
them; auto knobs resolve through it. The same store holds the calibrated
peaks ``obs roofline --calibrate`` measures.

Port of ``heat3d_tpu.tune.cache``, in the same file format, so one store
can serve both packages::

    {"schema": 1,
     "entries": {"<key>": {
         "config": {"backend": ..., "halo": ..., "overlap": ...,
                    "time_blocking": ..., "halo_order": ..., "halo_plan": ...,
                    "fused_rdma": ..., "mesh": [..], "equation": ...,
                    "eq_params": [..], "integrator": ...},
         "gcell_per_sec_per_chip": <winner metric>,
         "default_gcell_per_sec_per_chip": <static-default metric or null>,
         "provenance": {"run_id": ..., "ts": ..., "torch_version": ...,
                        "kernels": ..., "platform": ..., "chip": ...}}},
     "peaks": {"<chip>": {"vector_gflops": <calibrated>,
                          "provenance": {...}}}}

The key is the JAX package's,
``<chip>|p<processes>|d<devices>|g2^<bucket>|<fingerprint>|<dtype>[|b2^<batch>][|ti:<integrator>]``:
the chip generation (the card's name, lowercased, spaces as dashes:
``nvidia-h100-80gb-hbm3``; ``cpu``), the process and mesh device counts,
round(log2(cells per mesh device)), the equation fingerprint
(``eqn.fingerprint``: the bare stencil kind for heat) and the storage
dtype. Where the port differs, on purpose:

- **Process count.** ``p`` is ``torch.distributed.get_world_size()`` when
  a process group is initialized, else 1; reading it never initializes
  CUDA.
- **Shards per card.** One process may put several shards on one card
  (``device=`` of the solver: every shard on it). Then the key ends with
  one more leg, ``s<shards per card>``, so an (8,1,1) winner measured with
  eight shards on one card never steers a run with one shard on each of
  eight cards. With one shard per card the key equals the JAX key for the
  same config.
- **Staleness.** An entry is stale when its ``torch_version`` is not this
  process's, and when its ``kernels`` digest (``ops._build.kernels_digest``:
  every CUDA source, the shared headers and the flags) is not the tree's:
  an edited kernel is another stack, so its old winner is no evidence. An
  entry that carries ``jax_version`` and no ``torch_version`` is the JAX
  package's own, in a shared store: stale for resolution here, with a
  reason that says so; ``lint`` does not count it as a defect. (The JAX
  package marks the port's entries stale in turn: they have no
  ``jax_version``.)
- **No platform gate for ``halo='dma'``.** The JAX package marks a cached
  ``dma`` stale off the TPU; the port's DMA transport runs on the card and,
  through its plain version, on the CPU, and the key's chip leg keeps CPU
  entries and card entries apart.
- **Build check.** A hit is applied only when the resolved config builds
  here: :func:`_resolved_invalid` builds the port's solver through
  ``space.prune_reason`` on the run's device. A solver build allocates no
  field on the card.

Resolution (:func:`resolve_config`) replaces ONLY the auto knobs —
``backend='auto'``, ``halo='auto'``, ``time_blocking=0``,
``halo_plan='auto'``, ``fused_rdma='auto'`` — with the cached winner's
values; explicit knobs are never overridden and the mesh is never swapped.
Every resolution lands in the run ledger as ``tune_cache_hit`` /
``tune_cache_miss`` / ``tune_cache_stale``; misses and staleness fall back
to the static defaults (halo ``ppermute``, time_blocking 1, halo_plan
``monolithic``, fused_rdma ``off``; backend stays ``auto``, which takes
the kernels). Resolution fails soft: no cache error can kill the run being
configured. Non-default integrators pin their auto knobs through
``timeint.pin_config`` and never consult the cache.

``HEAT3D_TUNE_CACHE`` overrides the store path (default
``~/.cache/heat3d/tune_cache.json``, the JAX package's too);
``HEAT3D_TUNE_DISABLE=1`` skips the lookup (the search sets it
around its own trials).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from heat3d_tpu_torch.core.config import DEFAULT_INTEGRATOR, SolverConfig
from heat3d_tpu_torch.parallel.distributed import process_count

ENV_CACHE = "HEAT3D_TUNE_CACHE"
ENV_DISABLE = "HEAT3D_TUNE_DISABLE"
SCHEMA_VERSION = 1

# the knobs an entry's config must carry (lint + resolution contract)
CONFIG_KNOBS = (
    "backend", "halo", "overlap", "time_blocking", "halo_order", "halo_plan",
    "fused_rdma",
)

# in-process memo: (path) -> (mtime_ns, doc)
_DOC_CACHE: Dict[str, Tuple[int, Dict[str, Any]]] = {}


def cache_path(explicit: Optional[str] = None) -> str:
    """The store path: explicit arg > $HEAT3D_TUNE_CACHE > the per-user
    default."""
    if explicit:
        return explicit
    env = os.environ.get(ENV_CACHE)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "heat3d", "tune_cache.json"
    )


def chip_generation(device=None) -> str:
    """Normalized accelerator generation (``nvidia-h100-80gb-hbm3`` /
    ``cpu`` / ``unknown``) — the hardware axis of a store key: the card
    ``device`` names (default: the first), or ``cpu`` for a CPU device.
    Never raises (a key must be computable even when the device is
    wedged), and never touches CUDA on a build without it."""
    try:
        import torch

        if device is not None and torch.device(device).type == "cpu":
            return "cpu"
        if torch.version.cuda is None or not torch.cuda.is_available():
            return "cpu"
        dev = 0 if device is None or torch.device(device).index is None else device
        kind = torch.cuda.get_device_name(dev)
        return str(kind).strip().lower().replace(" ", "-") or "unknown"
    except Exception:  # noqa: BLE001 - key derivation fails soft
        return "unknown"


def shards_per_device(cfg: SolverConfig, device=None) -> int:
    """Shards per card of ``cfg`` placed as the solver places them: every
    shard on ``device`` when one is given, else shard i on ``cuda:i``."""
    return cfg.mesh.num_devices // process_count() if device is not None else 1


def _grid_bucket(cfg: SolverConfig) -> int:
    cells = max(cfg.grid.num_cells // max(cfg.mesh.num_devices, 1), 1)
    return round(math.log2(cells))


def cache_key(cfg: SolverConfig, batch_size: int = 1, device=None) -> str:
    """The lookup key for ``cfg`` placed on ``device`` (the solver's
    placement) in the CURRENT environment: the chip generation and the
    process count are read live, so the same config keys differently on
    different hardware, by design. ``batch_size`` > 1 appends the JAX
    package's batch-shape bucket; a non-default integrator its ``ti`` leg;
    several shards on one card the port's ``s`` leg (module docstring)."""
    from heat3d_tpu_torch import eqn

    parts = [
        chip_generation(device),
        f"p{process_count()}",
        f"d{cfg.mesh.num_devices}",
        f"g2^{_grid_bucket(cfg)}",
        eqn.fingerprint(cfg),
        cfg.precision.storage,
    ]
    if batch_size > 1:
        parts.append(f"b2^{round(math.log2(batch_size))}")
    if cfg.integrator != DEFAULT_INTEGRATOR:
        parts.append(f"ti:{cfg.integrator}")
    spd = shards_per_device(cfg, device)
    if spd > 1:
        parts.append(f"s{spd}")
    return "|".join(parts)


def config_knobs(cfg: SolverConfig) -> Dict[str, Any]:
    """The judged knob values of ``cfg`` as a plain dict (entry payload).
    ``equation``, ``eq_params`` and ``integrator`` are workload context,
    not searched knobs: persisted so ``tune apply`` can rebuild the
    measured workload's flag line; resolution never applies them (they
    are not in :data:`CONFIG_KNOBS`)."""
    return {
        "backend": cfg.backend,
        "halo": cfg.halo,
        "overlap": bool(cfg.overlap),
        "time_blocking": int(cfg.time_blocking),
        "halo_order": cfg.halo_order,
        "halo_plan": cfg.halo_plan,
        "fused_rdma": cfg.fused_rdma,
        "mesh": list(cfg.mesh.shape),
        "equation": cfg.equation,
        "eq_params": [[k, v] for k, v in cfg.eq_params],
        "integrator": cfg.integrator,
    }


# ---- store IO ---------------------------------------------------------------


def _empty_doc() -> Dict[str, Any]:
    return {"schema": SCHEMA_VERSION, "entries": {}, "peaks": {}}


def load(path: Optional[str] = None) -> Dict[str, Any]:
    """The parsed store document (empty document for a missing/unreadable
    file — a broken store degrades to "no store", never to a crash)."""
    p = cache_path(path)
    try:
        st = os.stat(p)
    except OSError:
        return _empty_doc()
    memo = _DOC_CACHE.get(p)
    if memo is not None and memo[0] == st.st_mtime_ns:
        return memo[1]
    try:
        with open(p) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return _empty_doc()
    if not isinstance(doc, dict):
        doc = _empty_doc()
    doc.setdefault("schema", SCHEMA_VERSION)
    for section in ("entries", "peaks"):
        if not isinstance(doc.get(section), dict):
            doc[section] = {}
    _DOC_CACHE[p] = (st.st_mtime_ns, doc)
    return doc


def _save(doc: Dict[str, Any], path: Optional[str] = None) -> str:
    """Atomic write (tmp + rename): a reader never sees a torn store."""
    p = cache_path(path)
    d = os.path.dirname(os.path.abspath(p))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tune_cache.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _DOC_CACHE.pop(p, None)
    return p


def kernels_digest() -> Optional[str]:
    """The tree's kernels digest (``ops._build.kernels_digest``), or None
    when it cannot be read."""
    try:
        from heat3d_tpu_torch.ops._build import kernels_digest as digest

        return digest()
    except Exception:  # noqa: BLE001 - provenance fails soft
        return None


def _provenance(device=None, **extra: Any) -> Dict[str, Any]:
    import datetime

    prov: Dict[str, Any] = {
        "ts": datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"
        ),
        "chip": chip_generation(device),
        "kernels": kernels_digest(),
    }
    try:
        import torch

        prov["torch_version"] = torch.__version__
        prov["platform"] = "cuda" if prov["chip"] not in ("cpu", "unknown") else "cpu"
    except Exception:  # noqa: BLE001
        prov["torch_version"] = None
        prov["platform"] = None
    from heat3d_tpu_torch import obs

    prov["run_id"] = obs.get().run_id
    prov.update(extra)
    return prov


def is_jax_entry(e: Dict[str, Any]) -> bool:
    """Whether a store entry is the JAX package's: ``jax_version`` in its
    provenance and no ``torch_version``."""
    prov = e.get("provenance") if isinstance(e, dict) else None
    return (isinstance(prov, dict) and bool(prov.get("jax_version"))
            and not prov.get("torch_version"))


def store_entry(
    key: str,
    winner_cfg: SolverConfig,
    metric: float,
    default_metric: Optional[float] = None,
    path: Optional[str] = None,
    device=None,
    **prov_extra: Any,
) -> str:
    """Write/overwrite the winner for ``key``; returns the store path."""
    doc = dict(load(path))
    entries = dict(doc.get("entries") or {})
    entries[key] = {
        "config": config_knobs(winner_cfg),
        "gcell_per_sec_per_chip": float(metric),
        "default_gcell_per_sec_per_chip": (
            None if default_metric is None else float(default_metric)
        ),
        "provenance": _provenance(device, **prov_extra),
    }
    doc["entries"] = entries
    return _save(doc, path)


def store_peak(
    chip: str,
    vector_gflops: float,
    path: Optional[str] = None,
    **prov_extra: Any,
) -> str:
    """Record a calibrated vector peak for ``chip`` (the store's ``peaks``
    section — ``obs roofline --calibrate`` writes through here)."""
    doc = dict(load(path))
    peaks = dict(doc.get("peaks") or {})
    peaks[chip] = {
        "vector_gflops": float(vector_gflops),
        "provenance": _provenance(**prov_extra),
    }
    doc["peaks"] = peaks
    return _save(doc, path)


def load_peak(chip: str, path: Optional[str] = None) -> Optional[float]:
    """The calibrated vector peak for ``chip``, or None. Never raises."""
    try:
        rec = (load(path).get("peaks") or {}).get(chip)
        v = rec.get("vector_gflops") if isinstance(rec, dict) else None
        return float(v) if isinstance(v, (int, float)) and v > 0 else None
    except Exception:  # noqa: BLE001 - peak lookup is telemetry
        return None


# ---- schema lint ------------------------------------------------------------


def lint(path: Optional[str] = None) -> List[str]:
    """Schema defects of the store at ``path`` (empty list = clean; a
    missing store is clean). An entry of the JAX package (``jax_version``,
    no ``torch_version``) is checked for its schema, not for the port's
    provenance fields."""
    p = cache_path(path)
    if not os.path.exists(p):
        return []
    try:
        with open(p) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable store: {type(e).__name__}: {e}"]
    bad: List[str] = []
    if not isinstance(doc, dict):
        return ["store is not a JSON object"]
    if doc.get("schema") != SCHEMA_VERSION:
        bad.append(
            f"schema {doc.get('schema')!r} != {SCHEMA_VERSION} "
            "(regenerate with `python -m heat3d_tpu_torch tune run`)"
        )
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        bad.append("'entries' is not an object")
        entries = {}
    for key, e in entries.items():
        where = f"entry {key!r}"
        if not isinstance(e, dict):
            bad.append(f"{where}: not an object")
            continue
        cfgd = e.get("config")
        if not isinstance(cfgd, dict):
            bad.append(f"{where}: missing config")
        else:
            for k in CONFIG_KNOBS:
                if k not in cfgd:
                    bad.append(f"{where}: config missing knob {k!r}")
            tb = cfgd.get("time_blocking")
            if tb is not None and (not isinstance(tb, int) or tb < 1):
                bad.append(f"{where}: time_blocking {tb!r} not an int >= 1")
            for knob in ("backend", "halo", "halo_plan", "fused_rdma"):
                if cfgd.get(knob) == "auto":
                    bad.append(
                        f"{where}: {knob}='auto' is not a concrete route "
                        "(entries must store what executes)"
                    )
        if not isinstance(e.get("gcell_per_sec_per_chip"), (int, float)):
            bad.append(f"{where}: missing numeric gcell_per_sec_per_chip")
        prov = e.get("provenance")
        if not isinstance(prov, dict):
            bad.append(f"{where}: missing provenance")
        elif not is_jax_entry(e):
            if not prov.get("torch_version"):
                bad.append(f"{where}: provenance missing torch_version")
            if not prov.get("kernels"):
                bad.append(f"{where}: provenance missing the kernels digest")
    peaks = doc.get("peaks")
    if peaks is not None and not isinstance(peaks, dict):
        bad.append("'peaks' is not an object")
    for chip, rec in (peaks or {}).items():
        if not (
            isinstance(rec, dict)
            and isinstance(rec.get("vector_gflops"), (int, float))
            and rec["vector_gflops"] > 0
        ):
            bad.append(f"peak {chip!r}: missing positive vector_gflops")
    return bad


# ---- resolution -------------------------------------------------------------


def _static_fallback(cfg: SolverConfig) -> SolverConfig:
    """The pre-tuner defaults for the auto knobs (backend keeps 'auto':
    the solver's own rule, ``models.heat3d.resolved_backend_name``)."""
    kw: Dict[str, Any] = {}
    if cfg.halo == "auto":
        kw["halo"] = "ppermute"
    if cfg.time_blocking == 0:
        kw["time_blocking"] = 1
    if cfg.halo_plan == "auto":
        kw["halo_plan"] = "monolithic"
    if cfg.fused_rdma == "auto":
        kw["fused_rdma"] = "off"
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _auto_knobs(cfg: SolverConfig) -> List[str]:
    autos = []
    if cfg.backend == "auto":
        autos.append("backend")
    if cfg.halo == "auto":
        autos.append("halo")
    if cfg.time_blocking == 0:
        autos.append("time_blocking")
    if cfg.halo_plan == "auto":
        autos.append("halo_plan")
    if cfg.fused_rdma == "auto":
        autos.append("fused_rdma")
    return autos


def resolve_config(
    cfg: SolverConfig,
    path: Optional[str] = None,
    batch_size: int = 1,
    device=None,
) -> SolverConfig:
    """Resolve ``cfg``'s auto knobs through the tuning cache, for a solver
    placed on ``device`` (the solver's ``device=``: the key's placement and
    where the build check runs).

    No auto knobs -> the config unchanged (no IO). Otherwise the entry for
    :func:`cache_key` supplies the values; a ledger event records the
    outcome (``tune_cache_hit`` with the applied knobs,
    ``tune_cache_miss``, or ``tune_cache_stale`` with the reason). Any
    failure — unreadable store, stale entry, cached knobs that do not build
    here — falls back to :func:`_static_fallback`. Never raises.

    Non-default integrators never consult the cache: their autos pin
    through ``timeint.pin_config``, the rule the solver constructor
    shares. Across processes rank 0 resolves and broadcasts its result
    (``broadcast_object_list``), so two ranks never take two routes; every
    rank calls this at the same point."""
    if cfg.integrator != DEFAULT_INTEGRATOR:
        from heat3d_tpu_torch import timeint

        return timeint.pin_config(cfg)
    from heat3d_tpu_torch.parallel import distributed

    global _RESOLVING_ALONE
    if distributed.process_count() > 1 and _auto_knobs(cfg) and not _RESOLVING_ALONE:
        mine = None
        if distributed.process_index() == 0:
            # the build check constructs solvers: their own resolution
            # stays on this rank
            _RESOLVING_ALONE = True
            try:
                # the lint's chain (the build check's HeatSolver3D ->
                # resolve_config -> broadcast) is cut at run time: the
                # solvers build their plans on first use and resolve
                # nothing under _RESOLVING_ALONE
                mine = _resolve_here(cfg, path, batch_size, device)  # heat3d-lint: ok=collective-divergence reaches no collective
            finally:
                _RESOLVING_ALONE = False
        return distributed.broadcast_object(mine)
    return _resolve_here(cfg, path, batch_size, device)


# set while rank 0 resolves for every rank (no nested broadcast)
_RESOLVING_ALONE = False


def _resolve_here(cfg: SolverConfig, path, batch_size: int, device) -> SolverConfig:
    """:func:`resolve_config` in this process alone."""
    try:
        autos = _auto_knobs(cfg)
        if not autos or os.environ.get(ENV_DISABLE):
            return _static_fallback(cfg)
        return _resolve(cfg, autos, path, batch_size=batch_size, device=device)
    except Exception:  # noqa: BLE001 - resolution must never kill a run
        try:
            return _static_fallback(cfg)
        except Exception:  # noqa: BLE001
            return cfg


# per-process dedup of miss/stale events: resolution runs at the entry
# point AND the solver constructor, so without this every run would ledger
# the same miss twice (keyed per run_id so a new ledger segment re-emits)
_EVENT_ONCE: set = set()


def _event_once(name: str, key: str, **fields: Any) -> None:
    from heat3d_tpu_torch import obs

    ledger = obs.get()
    tag = (ledger.run_id, name, key)
    if tag in _EVENT_ONCE:
        return
    _EVENT_ONCE.add(tag)
    ledger.event(name, key=key, **fields)


def _resolved_invalid(resolved: SolverConfig, device=None) -> Optional[str]:
    """Why the cache-resolved config cannot BUILD here, or None: the
    port's solver and its fixed-step loop built on ``device``
    (``space.prune_reason``), so the gates are the production gates. The
    build allocates no field."""
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.tune.space import prune_reason

    return prune_reason(resolved, lambda c: HeatSolver3D(c, device=device))


def _resolve(
    cfg: SolverConfig,
    autos: List[str],
    path: Optional[str],
    batch_size: int = 1,
    device=None,
) -> SolverConfig:
    p = cache_path(path)
    key = cache_key(cfg, batch_size=batch_size, device=device)
    entry = (load(p).get("entries") or {}).get(key)
    if not isinstance(entry, dict):
        _event_once(
            "tune_cache_miss",
            key,
            path=p,
            cache_present=os.path.exists(p),
            autos=autos,
        )
        return _static_fallback(cfg)

    def _stale(reason: str) -> SolverConfig:
        _event_once(
            "tune_cache_stale", key, path=p, reason=reason, autos=autos
        )
        return _static_fallback(cfg)

    prov = entry.get("provenance") or {}
    if is_jax_entry(entry):
        return _stale(
            f"entry written by the JAX package (jax_version "
            f"{prov.get('jax_version')!r}, no torch_version): measured on "
            "another stack"
        )
    import torch

    tv = torch.__version__
    if prov.get("torch_version") != tv:
        # another torch may route or launch differently: the measured
        # winner is evidence about a stack that no longer exists
        return _stale(f"torch_version {prov.get('torch_version')!r} != {tv!r}")
    kd = kernels_digest()
    if prov.get("kernels") != kd:
        return _stale(
            f"kernels {prov.get('kernels')!r} != {kd!r} (the CUDA sources, "
            "headers or flags changed since the measurement)"
        )
    cfgd = entry.get("config")
    if not isinstance(cfgd, dict) or any(k not in cfgd for k in CONFIG_KNOBS):
        return _stale("entry config missing knobs (schema drift)")
    kw: Dict[str, Any] = {}
    for knob in autos:
        kw[knob] = cfgd[knob]
    # an entry must supply CONCRETE values for the knobs it resolves
    if (
        kw.get("halo") == "auto"
        or kw.get("backend") == "auto"
        or kw.get("time_blocking") == 0
        or kw.get("halo_plan") == "auto"
        or kw.get("fused_rdma") == "auto"
    ):
        return _stale("entry carries unresolved auto knobs")
    try:
        resolved = dataclasses.replace(cfg, **kw)
    except (ValueError, TypeError) as e:
        return _stale(f"cached knobs invalid here: {e}")
    # the full build gates: the key buckets grid shapes (and the entry may
    # predate an env change), so the cached knobs can be invalid for THIS
    # exact config even on the same hardware
    reason = _resolved_invalid(resolved, device)
    if reason is not None:
        return _stale(f"cached knobs do not build here: {reason}")
    # hits are NOT deduped: a hit consumes the auto knobs it applies, so
    # the constructor's safety net has nothing left to re-resolve
    from heat3d_tpu_torch import obs

    obs.get().event(
        "tune_cache_hit",
        key=key,
        path=p,
        applied={k: kw[k] for k in autos},
        gcell_per_sec_per_chip=entry.get("gcell_per_sec_per_chip"),
        cached_ts=prov.get("ts"),
        cached_run_id=prov.get("run_id"),
    )
    return resolved

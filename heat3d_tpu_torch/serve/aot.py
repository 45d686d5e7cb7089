"""The warm-up cache of the serving tier: a bucket's first-use stall,
paid once per process and measured.

Port of ``heat3d_tpu.serve.aot``. The JAX package compiles a bucket's
ensemble ahead of time and serializes the PJRT executable into a store
that a fresh process loads. The port's ensemble is eager
(``serve/ensemble.py``): it has no program to trace, compile or
serialize, and PyTorch can write neither an eager loop nor a CUDA graph
to disk. What a bucket's first request would pay here is the first-use
cost of its shapes: the exchange plans, the caching allocator's growth to
the batch's working set and the lazy loading of torch's kernels for the
bucket's dtypes. :func:`warm` pays that cost ahead of the request, with
one pass over device zeros (one update and one superstep at the bucket's
time blocking, the residual probe), and measures it.

The key (:func:`aot_key`) keeps every leg of the JAX key: the structural
bucket (:func:`~heat3d_tpu_torch.serve.scenario.solver_bucket_key`), the
padded batch size and batch-mesh factorization, the tune-cache key at
the batch bucket, the resolved route legs (Mehrstellen, coefficient
fields, time blocking, the effective exchange-plan mode and its floor,
the chain-factoring knobs), and the toolchain: ``torch.__version__``,
``torch.version.cuda``, the device type, kind and count, and the port's
kernels digest (``ops._build.kernels_digest``).

The store is this process's: a key warmed once lands
``aot_cache_hit`` (its ``load_s`` the caller's rebuild seconds, no
``compile_stall``) every later time — the engine's rebuild of a bucket's
solvers after a backend loss is such a hit. A key first seen in this
process lands ``aot_cache_miss`` and a ``compile_stall`` event with the
measured seconds. A fresh process always pays each key once; nothing is
exported and the store directory is never written (``aot_export`` does
not land). An entry whose toolchain no longer matches this process's is
``aot_cache_stale`` and is warmed again.

``HEAT3D_AOT_CACHE`` names the store (the directory the JAX package
would write; here the namespace of this process's entries, default
``~/.cache/heat3d/aot``); ``0``/``off`` disables it — every warm-up is
then paid and measured (outcome ``disabled``), none is remembered. The
entries live in a module-level table: the store is the process's by
design (its hits are what a rebuild after a backend loss must find), and
the directory in each entry's key keeps stores apart.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch

from heat3d_tpu_torch import obs

ENV_AOT = "HEAT3D_AOT_CACHE"
AOT_SCHEMA = 1

# (store directory, key) -> the provenance the entry was warmed under
_WARMED: Dict[Tuple[str, str], Dict[str, Any]] = {}
_LOCK = threading.Lock()


def aot_dir(explicit: Optional[str] = None) -> Optional[str]:
    """The store directory: explicit arg > ``$HEAT3D_AOT_CACHE`` > the
    per-user default. ``None`` when disabled (env set to ``0``/``off``)."""
    if explicit:
        return explicit
    env = os.environ.get(ENV_AOT)
    if env is not None:
        if env.strip().lower() in ("", "0", "off"):
            return None
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "heat3d", "aot")


def _toolchain(solver=None) -> Dict[str, Any]:
    """The provenance legs a warmed entry is valid under: the torch and
    CUDA versions, the solver's device type, the card's kind and the
    visible device count, and the kernels digest."""
    prov: Dict[str, Any] = {"schema": AOT_SCHEMA}
    try:
        dev = getattr(solver, "device", None)
        dtype = dev.type if dev is not None else (
            "cuda" if torch.cuda.is_available() else "cpu")
        prov["torch_version"] = torch.__version__
        prov["cuda_version"] = torch.version.cuda
        prov["platform"] = dtype
        if dtype == "cuda":
            prov["devices"] = torch.cuda.device_count()
            prov["device_kind"] = torch.cuda.get_device_name(dev)
        else:
            prov["devices"] = 1
            prov["device_kind"] = "cpu"
        from heat3d_tpu_torch.tune.cache import kernels_digest

        prov["kernels"] = kernels_digest()
    except Exception:  # noqa: BLE001 - provenance derivation fails soft
        prov.update(torch_version=None, cuda_version=None, platform=None,
                    devices=0, device_kind=None, kernels=None)
    return prov


_LEGS = ("torch_version", "cuda_version", "platform", "devices", "device_kind",
         "kernels")


def aot_key(solver) -> str:
    """The content key of ``solver``'s warm-up: a hash over the structural
    bucket, the batch factorization, the tune-cache key at the batch
    bucket (chip/processes/working-set/equation/dtype context), every
    resolved leg that shapes the batched loop beyond the bucket
    (Mehrstellen decomposability, coefficient fields, time_blocking after
    auto-resolution, the EFFECTIVE exchange-plan mode and partition floor,
    the chain-factoring env gates) and the toolchain."""
    from heat3d_tpu_torch.parallel.plan import effective_halo_plan
    from heat3d_tpu_torch.serve.scenario import solver_bucket_key
    from heat3d_tpu_torch.tune import cache as tcache

    tc = _toolchain(solver)
    doc = {
        "bucket": [list(x) if isinstance(x, tuple) else x
                   for x in solver_bucket_key(solver.cfg)],
        "B": solver.B,
        "batch_mesh": solver.batch_mesh,
        "bind": solver.bind,
        "tune_key": tcache.cache_key(solver.cfg, batch_size=solver.B,
                                     device=getattr(solver, "_placement", None)),
        "mehrstellen": bool(solver._mehrstellen),
        "coef_fields": bool(getattr(solver, "_varcoef", False)),
        "time_blocking": solver.cfg.time_blocking,
        "halo_plan": effective_halo_plan(solver.cfg),
        "plan_floor": os.environ.get("HEAT3D_PLAN_PART_MIN_BYTES"),
        "factor_env": [
            os.environ.get("HEAT3D_FACTOR_7PT"),
            os.environ.get("HEAT3D_FACTOR_Y"),
        ],
        **{leg: tc[leg] for leg in _LEGS},
        "schema": AOT_SCHEMA,
    }
    blob = json.dumps(doc, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def _stale_reason(entry: Dict[str, Any], solver) -> Optional[str]:
    """Why a remembered entry cannot serve this process any more, or
    None. The key already hashes the toolchain, so a mismatch means a
    hash collision or a tampered entry — checked anyway."""
    tc = _toolchain(solver)
    for leg in _LEGS:
        if entry.get(leg) != tc[leg]:
            return f"{leg} {entry.get(leg)!r} != {tc[leg]!r}"
    if entry.get("schema") != AOT_SCHEMA:
        return f"schema {entry.get('schema')!r} != {AOT_SCHEMA}"
    return None


def warm_pass(solver) -> None:
    """One pass of ``solver``'s batched loop at its shapes, on device
    zeros and on the calling thread's current streams: an update (and a
    superstep at time blocking k > 1, so both exchange plans are built),
    then the residual probe; waits for that work only. Touches no member
    value, so the solver serves as if it never ran."""
    from heat3d_tpu_torch.serve.ensemble import BatchedField
    from heat3d_tpu_torch.utils.timing import stream_sync

    shards = []
    for mesh in solver.groups:
        for s in mesh.local_shards:
            shards.append(torch.zeros((solver.Bl,) + tuple(solver.cfg.local_shape),
                                      dtype=solver.storage_dtype, device=s.device))
    u = BatchedField(shards, solver.mesh.shape)
    u = solver.run(u, solver.k + 1 if solver.k > 1 else 1)
    solver.step_with_member_residuals(u)
    stream_sync(solver)


def _pay(solver, bucket: str) -> float:
    """Run :func:`warm_pass`, measuring the first-use stall into a
    ``compile_stall`` ledger event (the cost a cold process pays, outside
    the first request's latency). Returns its seconds."""
    t0 = time.monotonic()
    warm_pass(solver)
    stall = time.monotonic() - t0
    obs.get().event(
        "compile_stall",
        bucket=bucket,
        programs=["warm_pass"],
        seconds=round(stall, 6),
    )
    return stall


def warm(solver, directory: Optional[str] = None,
         build_s: Optional[float] = None) -> Dict[str, Any]:
    """Pay-and-measure ``solver``'s first-use stall, once per key and
    process.

    Hit: the key was warmed in this process — ``aot_cache_hit`` with
    ``load_s`` (``build_s``, the caller's seconds to build this solver;
    0.0 when not given), no stall. Miss / stale / disabled: run
    :func:`warm_pass` now (``compile_stall`` carries the measured
    seconds) and, unless disabled, remember the key. Returns a small
    report dict the engine aggregates into its stats (``exported`` is
    always False: nothing is written). Never raises for store defects;
    only a failing warm pass propagates."""
    report: Dict[str, Any] = {
        "source": "eager", "outcome": None, "load_s": None,
        "compile_stall_s": None, "exported": False,
    }
    bucket = repr(solver.batch.bucket_key())
    d = aot_dir(directory)
    if d is None:
        report.update(source="disabled", outcome="disabled",
                      compile_stall_s=_pay(solver, bucket))
        return report
    key = aot_key(solver)
    report["key"] = key
    with _LOCK:
        entry = _WARMED.get((d, key))
    if entry is None:
        obs.get().event("aot_cache_miss", key=key, dir=d, bucket=bucket)
        report["outcome"] = "miss"
    else:
        reason = _stale_reason(entry, solver)
        if reason is None:
            load_s = float(build_s or 0.0)
            obs.get().event(
                "aot_cache_hit",
                key=key,
                dir=d,
                bucket=bucket,
                programs=["warm_pass"],
                load_s=round(load_s, 6),
            )
            report.update(source="memory", outcome="hit", load_s=load_s)
            return report
        obs.get().event(
            "aot_cache_stale", key=key, dir=d, bucket=bucket, reason=reason
        )
        report["outcome"] = "stale"
    report.update(source="warmed", compile_stall_s=_pay(solver, bucket))
    with _LOCK:
        _WARMED[(d, key)] = {**_toolchain(solver), "created": time.time()}
    return report

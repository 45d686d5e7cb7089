"""The tuning store's peak section: the vector peak ``obs roofline
--calibrate`` measures on a card, stored under the card's name.

A copy of the JAX package's ``tune/cache.py`` store IO (``cache_path``,
``load``, the atomic save) and of its ``chip_generation``, ``store_peak``
and ``load_peak``, in the same file format (``{"schema": 1, "entries":
{...}, "peaks": {chip: {"vector_gflops": ..., "provenance": {...}}}}``),
so one store serves both packages. The generation is the card's name
(``torch.cuda.get_device_name``, lowercased, spaces as dashes). The
autotuner's entries (search, resolution, lint) are not here yet.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

ENV_CACHE = "HEAT3D_TUNE_CACHE"
SCHEMA_VERSION = 1

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


def chip_generation() -> str:
    """Normalized accelerator generation (``nvidia-h100-80gb-hbm3`` /
    ``cpu`` / ``unknown``) — the hardware axis of a store key. Never raises
    (a key must be computable even when the device is wedged), and never
    touches CUDA on a build without it."""
    try:
        import torch

        if torch.version.cuda is None or not torch.cuda.is_available():
            return "cpu"
        kind = torch.cuda.get_device_name(0)
        return str(kind).strip().lower().replace(" ", "-") or "unknown"
    except Exception:  # noqa: BLE001 - key derivation fails soft
        return "unknown"


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


def _provenance(**extra: Any) -> Dict[str, Any]:
    import datetime

    prov: Dict[str, Any] = {
        "ts": datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"
        ),
        "chip": chip_generation(),
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

"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration and the system module it names, its traffic mix and the
entry module it names, its limits and its metrics' readers."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
ROOT = PACKAGE_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of config ``name``, as BENCHMARK.json names it."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(traffic: str, root: Path = ROOT) -> dict:
    with open(root / "portbench" / "mixes" / f"{traffic}.json") as f:
        return json.load(f)


def system(config: dict, root: Path = ROOT) -> ModuleType:
    """``systems/<system>.py`` of a configuration file (see
    ``portbench.systems``)."""
    return _module("systems", config["system"], root)


def entry(mix: dict, root: Path = ROOT) -> ModuleType:
    """``entries/<entry>.py`` of a traffic mix (see ``portbench.entries``)."""
    return _module("entries", mix["entry"], root)


def limits(cell: str, root: Path = ROOT) -> Dict[str, float]:
    """``{number: limit}`` of the cell's comparison with the reference."""
    with open(root / "portbench" / "limits" / f"{cell}.json") as f:
        doc = json.load(f)
    return {name: float(entry["limit"]) for name, entry in doc["numbers"].items()}


def metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    a trace, the per-layer ones with it; a metric with a ``workloads`` key
    only in the cells it lists."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """``read(ctx)`` of ``metrics/<name>.py``: the metric's value from the
    run's context, or None where it finds nothing to read."""
    return _module("metrics", name, root).read


def _module(kind: str, name: str, root: Path) -> ModuleType:
    """``portbench/<kind>/<name>.py``, loaded once by its path (a name may
    hold dots)."""
    path = root / "portbench" / kind / f"{name}.py"
    key = f"portbench.{kind}.{name}"
    if key not in _MODULES:
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or spec.loader is None or not path.is_file():
            raise FileNotFoundError(path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[key] = module
    return _MODULES[key]


_MODULES: Dict[str, ModuleType] = {}

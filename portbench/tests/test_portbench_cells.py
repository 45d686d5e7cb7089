"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest

from portbench import cells, drive
from portbench.reference.heat import stable_dt

BENCH = cells.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(m["bound"] <= 0.25 and m["bound"] >= 0.01 for m in BENCH["end_to_end"])
    layers = {m["name"]: m for m in BENCH["end_to_end"]}
    assert all(m["moves"] in layers for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = cells.workload(BENCH, cell)
    config = cells.config(BENCH, w["config"])
    mix = cells.mix(w["traffic"])
    limits = cells.limits(cell)
    assert config["name"] == w["config"]
    system, entry = cells.system(config), drive.check_mix(mix)
    assert callable(system.solver) and callable(system.control) and callable(entry.chunk)
    system.solver_config(config, mix["run"])  # every key consumed
    assert set(limits) >= {"field_gap", "face_gap"}
    assert ("residual_gap" in limits) == entry.RESIDUAL
    assert w["chips"] == 1
    for trace in (False, True):
        for m in cells.metrics(BENCH, cell, trace):
            assert callable(cells.reader(m["name"]))
    assert cells.metrics(BENCH, cell, True), "every cell reports a per-layer metric"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    with open(cells.ROOT / entry["file"]) as f:
        config = json.load(f)
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert config["source_values"][key] != config[key]
    assert config["dt"] == pytest.approx(0.9 * stable_dt(config), rel=1e-12)
    assert config["bc"] == "dirichlet" and config["bc_value"] == 0.0
    assert config["storage"] == config["compute"] == config["residual"] == "float32"
    assert config["time_blocking"] == 2 and config["backend"] == "auto"


@pytest.mark.parametrize("key", ["integrator", "equation", "halo"])
def test_config_key_not_consumed_is_refused(key):
    """A configuration for another integrator, equation or placement never
    runs the heat solver quietly."""
    config = cells.config(BENCH, BENCH["configs"][0]["name"])
    system = cells.system(config)
    with pytest.raises(ValueError, match=key):
        system.solver_config(dict(config, **{key: "leapfrog"}), {})
    with pytest.raises(ValueError, match="lacks"):
        system.solver_config({k: v for k, v in config.items() if k != "dt"}, {})


@pytest.mark.parametrize("traffic", sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_mix_key_not_read_is_refused(traffic):
    mix = cells.mix(traffic)
    drive.check_mix(mix)
    with pytest.raises(ValueError, match="burst"):
        drive.check_mix(dict(mix, burst=4))
    with pytest.raises(FileNotFoundError):
        drive.check_mix(dict(mix, entry="no_such_entry"))

"""The port's performance observability on the CPU (``heat3d_tpu_torch.obs.
perf``): the JAX ``tests/test_perf.py`` cases the port covers (the
regression gate, the roofline row model and live table, step cost, profile
capture, merge, the timeline, drift and straggler detection), each held to
the JAX package's functions on the same synthetic rows and ledgers where
both have them; the torch-trace half of the timeline on a synthetic Chrome
trace with a known answer per phase and for the busy share; and the
analytic cost model against ``PERF.md``'s bound column (the yardstick
``chip_smoke.py`` imports)."""

import contextlib
import dataclasses
import io
import json
import os
import sys

import pytest
import torch

from heat3d_tpu.obs.perf import merge as jmerge
from heat3d_tpu.obs.perf import regress as jregress
from heat3d_tpu.obs.perf import roofline as jroofline
from heat3d_tpu.obs.perf import timeline as jtimeline
from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import (
    GridConfig,
    MeshConfig,
    Precision,
    SolverConfig,
    StencilConfig,
)
from heat3d_tpu_torch.obs.perf import merge, regress, roofline, timeline
from heat3d_tpu_torch.obs.perf.merge import merge_ledgers

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BW = 3.35e12  # the H100 SXM memory rate every bound is taken at


@pytest.fixture(autouse=True)
def _isolated_obs(tmp_path, monkeypatch):
    monkeypatch.delenv("HEAT3D_LEDGER", raising=False)
    monkeypatch.setenv("HEAT3D_TUNE_CACHE", str(tmp_path / "tune.json"))
    obs.deactivate()
    yield
    obs.deactivate()


def _read(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def _cfg(n=16, mesh=(1, 1, 1), **kw):
    return SolverConfig(grid=GridConfig.cube(n), mesh=MeshConfig(shape=mesh), **kw)


def _tput_row(gcell, platform="gpu", **over):
    row = {"bench": "throughput", "ts": "2026-08-01T00:00:00Z", "platform": platform,
           "grid": [256, 256, 256], "stencil": "7pt", "mesh": [1, 1, 1],
           "dtype": "float32", "compute_dtype": "float32", "backend": "auto",
           "time_blocking": 2, "overlap": False, "halo": "ppermute",
           "gcell_per_sec_per_chip": gcell, "sync_rtt_s": 0.001}
    row.update(over)
    return row


def _halo_row(p50_us, **over):
    row = {"bench": "halo", "ts": "2026-08-01T00:00:00Z", "platform": "gpu",
           "grid": [256, 256, 256], "mesh": [1, 1, 1], "dtype": "float32",
           "halo": "ppermute", "p50_us": p50_us, "sync_rtt_s": 0.001}
    row.update(over)
    return row


def _same_report(cur, hist):
    """The port's verdict on (cur, hist), checked equal to the JAX gate's."""
    a, b = regress.compare(cur, hist), jregress.compare(cur, hist)
    assert a == b
    return a


# ---- the regression gate ---------------------------------------------------------


def test_regress_injected_drop_fails():
    report = _same_report([_tput_row(80.0)], [_tput_row(100.0)])
    assert report["verdict"] == "fail"
    (c,) = report["comparisons"]
    assert c["status"] == "fail" and c["regression_pct"] == pytest.approx(20.0)


@pytest.mark.parametrize("now,verdict", [(100.0, "pass"), (130.0, "pass"), (90.0, "warn")])
def test_regress_bands(now, verdict):
    assert _same_report([_tput_row(now)], [_tput_row(100.0)])["verdict"] == verdict


def test_regress_cpu_row_never_compares_against_a_card_record():
    report = _same_report([_tput_row(0.5, platform="cpu")], [_tput_row(100.0)])
    assert report["verdict"] == "pass" and not report["comparisons"]
    assert report["no_baseline"][0]["platform"] == "cpu"


def test_regress_legacy_rows_keep_the_jax_default_platform():
    legacy = _tput_row(100.0)
    legacy.pop("platform")
    assert _same_report([_tput_row(70.0, platform="tpu")], [legacy])["verdict"] == "fail"


def test_regress_halo_direction_and_rtt_exclusion():
    assert _same_report([_halo_row(70.0)], [_halo_row(50.0)])["verdict"] == "fail"
    rep = _same_report([_halo_row(70.0, rtt_dominated=True)], [_halo_row(50.0)])
    assert not rep["comparisons"] and rep["skipped"]
    assert not _same_report([_halo_row(70.0)], [_halo_row(50.0, rtt_dominated=True)])[
        "comparisons"]


def test_regress_best_of_history_is_the_baseline():
    rep = _same_report([_tput_row(95.0)], [_tput_row(80.0), _tput_row(100.0), _tput_row(60.0)])
    assert rep["comparisons"][0]["baseline"] == 100.0 and rep["verdict"] == "pass"


def test_regress_cli_end_to_end(tmp_path, capsys):
    out = tmp_path / "results.jsonl"
    for cur, rc_want, verdict in ((80.0, 1, "fail"), (100.0, 0, "pass")):
        with open(out, "w") as f:
            f.write(json.dumps(_tput_row(100.0)) + "\n")
            f.write(json.dumps(_tput_row(cur)) + "\n")
        rc = regress.main([str(out), "--start-line", "2", "--history", "--json"])
        rep = json.loads(capsys.readouterr().out.strip())
        assert rc == rc_want and rep["verdict"] == verdict
        assert rep["tuned_configs"] == []


def test_regress_window_keeps_the_jax_rule():
    hist = [_tput_row(120.0, ts="2026-07-01T00:00:00Z"),
            _tput_row(100.0, ts="2026-08-01T00:00:00Z")]
    assert regress.filter_window(hist, 1) == jregress.filter_window(hist, 1)
    assert [r["gcell_per_sec_per_chip"] for r in regress.filter_window(hist, 1)] == [100.0]


# ---- roofline: the analytic cost model ---------------------------------------------


def test_bounds_reproduce_the_perf_table():
    """``PERF.md`` section 6's bound column at 1024^3 fp32 7pt, 3.35 TB/s:
    direct1/direct2 2.564 ms, streamk K=4 2.594, the halo exchange 2.572
    on one shard and 2.587 over (2,2,2)."""
    flops = roofline.flops_per_update(roofline_taps("7pt"))
    for name, k in (("apply_taps_direct", 1), ("apply_taps_direct2", 2)):
        ms, by = roofline.kernel_bound(name, 1024, k, 4, flops, BW)
        assert round(ms, 3) == 2.564 and by == "bytes"
    ms, _ = roofline.kernel_bound("apply_taps_streamk", 1024, 4, 4, flops, BW)
    assert round(ms, 3) == 2.594
    one = roofline.halo_exchange_bytes((1, 1, 1), (1024,) * 3, "axis", 4) / BW * 1e3
    eight = roofline.halo_exchange_bytes((2, 2, 2), (512,) * 3, "axis", 4) / BW * 1e3
    assert (round(one, 3), round(eight, 3)) == (2.572, 2.587)


def roofline_taps(kind, n=8):
    from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps

    g = GridConfig.cube(n)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


@pytest.mark.parametrize("tb", [1, 2])
def test_step_cost_of_the_headline_is_the_direct_bound(tb):
    """The cfg-level count the ledger's ``step_cost`` carries: one 1024^3
    direct sweep reads and writes the field (8 B a cell in fp32), over k
    updates at tb=k."""
    cfg = _cfg(1024, time_blocking=tb)
    f = roofline.step_cost_fields(cfg)
    assert f["cost_bytes_per_step"] * tb == 2 * 1024 ** 3 * 4
    assert round(f["cost_bytes_per_step"] * tb / BW * 1e3, 3) == 2.564
    assert f["cost_flops_per_step"] == 1024 ** 3 * roofline.flops_per_update(
        roofline_taps("7pt"))
    from heat3d_tpu_torch.parallel.step import redundant_flops_frac

    assert f["cost_redundant_flops_frac"] == redundant_flops_frac(cfg)


@pytest.mark.parametrize("route,mesh,tb,kw", [
    ("faces-direct", (2, 2, 2), 1, {}),
    ("faces-direct2", (2, 2, 2), 2, {}),
    ("fused-dma-3d", (2, 2, 2), 1, dict(halo="dma", overlap=True)),
    ("fused-dma", (8, 1, 1), 1, dict(halo="dma", overlap=True)),
    ("fused-dma2", (8, 1, 1), 2, dict(halo="dma", overlap=True)),
    ("exchange", (2, 2, 2), 1, dict(halo="dma")),
    ("streamk", (2, 2, 2), 4, dict(halo="dma")),
])
def test_step_cost_matches_the_sharded_bound(route, mesh, tb, kw):
    """A sharded route's per-call bytes are ``sharded_superstep_bound``'s,
    the figures of ``PERF.md`` section 5's bound column."""
    cfg = _cfg(1024, mesh, time_blocking=tb, **kw)
    assert roofline.step_route_of(cfg) == route
    flops = roofline.flops_per_update(roofline_taps("7pt"))
    _, _, moved = roofline.sharded_superstep_bound(route, 1024, mesh, tb, 4, flops, BW)
    assert roofline.step_cost(cfg)[0] == moved


def test_step_cost_deep_tb_raw_vs_effective():
    from heat3d_tpu_torch.parallel.step import redundant_flops_frac

    cfg = _cfg(8, time_blocking=3, backend="jnp")
    f = roofline.step_cost_fields(cfg)
    frac = redundant_flops_frac(cfg)
    assert 0.0 < frac < 1.0 and f["cost_redundant_flops_frac"] == frac
    assert f["cost_effective_flops_per_step"] == pytest.approx(f["cost_flops_per_step"] * (1 - frac))
    f1 = roofline.step_cost_fields(dataclasses.replace(cfg, time_blocking=1))
    assert f1["cost_redundant_flops_frac"] == 0.0
    assert f1["cost_effective_flops_per_step"] == f1["cost_flops_per_step"]


def test_record_step_cost_event_and_fail_soft(tmp_path):
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    solver = HeatSolver3D(_cfg(8, time_blocking=2), device="cpu")
    led = str(tmp_path / "led.jsonl")
    obs.activate(led)
    fields = roofline.record_step_cost(solver, post_heal=True, step=4)
    assert roofline.record_step_cost(object()) is None  # no cfg: ok false
    obs.deactivate()
    costs = [e for e in _read(led) if e["event"] == "step_cost"]
    assert len(costs) == 2
    assert costs[0]["ok"] and costs[0]["platform"] == "cpu" and costs[0]["post_heal"]
    assert costs[0]["cost_bytes_per_step"] == fields["cost_bytes_per_step"] == 8 ** 3 * 4
    assert costs[1]["ok"] is False and "error" in costs[1]


def test_throughput_row_carries_the_cost_fields():
    from heat3d_tpu_torch.bench import harness

    cfg = _cfg(16, time_blocking=2)
    row = harness.throughput_row(cfg, steps=4, steps_requested=4, times=[1e-3],
                                 devices=[torch.device("cpu")], shards=1, sync_rtt_s=1e-6,
                                 kernel_launches={})
    f = roofline.step_cost_fields(cfg)
    assert {k: row[k] for k in f} == f


def test_phase_programs_keyed_like_the_ranges():
    """The phase programs share the ``heat3d.*`` range names, each one runs
    alone on the CPU, and each has an analytic cost."""
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.parallel.step import PHASES, phase_programs

    for cfg, want in ((_cfg(16, time_blocking=2), {"step", "stencil", "halo_exchange",
                                                    "residual"}),
                      (_cfg(16, (4, 1, 1), halo="dma", overlap=True), set(PHASES))):
        solver = HeatSolver3D(cfg, device="cpu")
        progs = phase_programs(cfg, solver)
        assert set(progs) == want and set(progs) <= set(PHASES)
        us = solver._shards(solver.init_state("hot-cube"))
        for phase, fn in progs.items():
            fn(us)
            cost = roofline.phase_cost(cfg, phase)
            assert cost["bytes"] > 0, phase


def test_stencil_phase_equals_the_step_on_one_shard():
    """On a (1,1,1) direct route the stencil program is the step's kernel:
    the same field comes out."""
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.parallel.step import phase_programs

    cfg = _cfg(16, time_blocking=2)
    solver = HeatSolver3D(cfg, device="cpu")
    progs = phase_programs(cfg, solver)
    us = solver._shards(solver.init_state("gaussian"))
    a = [t.clone() for t in progs["step"](us)]
    b = progs["stencil"](us)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_roofline_live_table_on_cpu(capsys):
    rc = roofline.main(["--grid", "16", "--iters", "1", "--backend", "jnp",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    for phase in ("step", "halo_exchange", "stencil", "residual"):
        assert phase in out
    assert "%mem" in out and "GFLOP/s" in out and "[cpu]" in out


def test_roofline_live_json_has_positive_costs(capsys):
    rc = roofline.main(["--grid", "16", "--iters", "1", "--time-blocking", "2",
                        "--device", "cpu", "--json"])
    rep = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and rep["platform"] == "cpu"
    by = {r["phase"]: r for r in rep["phases"]}
    assert by["stencil"]["flops"] > 0 and by["step"]["bytes"] == 16 ** 3 * 4 * 2
    assert by["step"]["updates_per_call"] == 2 and by["stencil"]["seconds"] > 0


def test_calibrate_stores_a_peak_under_the_card_name(tmp_path, capsys):
    from heat3d_tpu_torch.tune.cache import chip_generation, load_peak

    store = str(tmp_path / "peaks.json")
    rc = roofline.main(["--calibrate", "--grid", "12", "--iters", "1", "--device", "cpu",
                        "--cache", store, "--json"])
    rec = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and rec["chip"] == chip_generation() == "cpu"
    assert load_peak("cpu", store) == rec["vector_gflops"] > 0
    doc = json.load(open(store))
    assert set(doc) == {"schema", "entries", "peaks"} and doc["schema"] == 1


def test_peak_spec_cuda_and_env_override(monkeypatch):
    """The card's memory rate is its published one by name; env overrides
    win; no TPU figure is in the table."""
    assert "tpu" not in roofline.PEAK_SPECS
    monkeypatch.setattr(roofline, "card_bandwidth", lambda: roofline.bandwidth(
        "NVIDIA H100 80GB HBM3"))
    assert roofline.peak_spec("cuda")["mem_gbps"] == 3350.0
    assert roofline.peak_spec("cuda")["vector_gflops"] == roofline.FP32_FLOPS / 1e9
    monkeypatch.setenv("HEAT3D_PEAK_MEM_GBPS", "1000")
    monkeypatch.setenv("HEAT3D_PEAK_GFLOPS", "7")
    assert roofline.peak_spec("cuda") == {"mem_gbps": 1000.0, "vector_gflops": 7.0}
    with pytest.raises(RuntimeError, match="no bandwidth"):
        roofline.bandwidth("TPU v5e")


def test_a_calibrated_rate_is_never_the_denominator(tmp_path, monkeypatch, capsys):
    """``--calibrate`` stores what the 27pt chain achieved; the peaks stay
    the card's own, and the live table shows the figure beside them."""
    monkeypatch.setenv("HEAT3D_TUNE_CACHE", str(tmp_path / "tune.json"))
    before = {p: roofline.peak_spec(p) for p in ("cpu", "cuda")}
    assert roofline.calibrated_gflops("cpu") is None
    assert roofline.main(["--calibrate", "--grid", "12", "--iters", "1", "--device",
                          "cpu", "--json"]) == 0
    cal = json.loads(capsys.readouterr().out.strip())["vector_gflops"]
    assert roofline.calibrated_gflops("cpu") == cal > 0
    assert roofline.calibrated_gflops("cuda") is None  # not this process's card
    assert {p: roofline.peak_spec(p) for p in ("cpu", "cuda")} == before
    assert roofline.main(["--grid", "12", "--iters", "1", "--device", "cpu"]) == 0
    assert f"calibrated {cal:.2f} GFLOP/s, not a peak" in capsys.readouterr().out


@pytest.mark.parametrize("tb", [1, 2])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
def test_a_memory_bound_stencil_stays_under_the_vector_peak(kind, tb, monkeypatch):
    """A stencil phase at the card's full memory rate does fewer operations
    a second than the card's fp32 peak, so the live table reads it as
    memory-bound and under 100% of the vector peak."""
    monkeypatch.setattr(roofline, "card_bandwidth", lambda: BW)
    cfg = _cfg(1024, time_blocking=tb, stencil=StencilConfig(kind=kind))
    cost = roofline.phase_cost(cfg, "stencil")
    seconds = cost["bytes"] / BW  # the phase at the memory rate
    gflops = cost["flops"] / seconds / 1e9
    assert gflops < roofline.peak_spec("cuda")["vector_gflops"]
    rec = {"phase": "stencil", **cost, "seconds": seconds, "gflops": gflops,
           "gbps": cost["bytes"] / seconds / 1e9}
    out = io.StringIO()
    roofline.print_live_table(cfg, [rec], "cuda", out=out)
    row = out.getvalue().splitlines()[-1].split()
    assert row[0] == "stencil" and row[-1] == "mem" and row[-2] == "100.0%"
    assert float(row[-3].rstrip("%")) < 100.0


# ---- roofline: the row model, against the JAX package's ------------------------------


ROW_CASES = [
    dict(time_blocking=1, direct_path=True),
    dict(time_blocking=2, direct_path=True, mesh=[2, 2, 2]),
    dict(time_blocking=4, streamk_path=True),
    dict(time_blocking=1, fused_dma_path=True, mesh=[8, 1, 1]),
    dict(time_blocking=2, fused_rdma_path=True, halo_plan="partitioned"),
    dict(time_blocking=1, direct_path=False, halo="dma", dtype="bfloat16"),
    dict(time_blocking=3, halo_plan="partitioned"),
]


@pytest.mark.parametrize("over", ROW_CASES, ids=lambda d: ",".join(map(str, d.values())))
def test_row_model_equals_jax(over):
    row = _tput_row(200.0, chain_ops=13, **over)
    assert roofline.bytes_per_cell_update(row) == jroofline.bytes_per_cell_update(row)
    assert roofline.vpu_ops_per_cell_update(row) == jroofline.vpu_ops_per_cell_update(row)


def test_row_report_and_fit_equal_jax(tmp_path):
    rows = [_tput_row(100.0 + 10 * i, chain_ops=c, time_blocking=1, direct_path=True)
            for i, c in enumerate((9, 11, 13))]
    outs = []
    for mod in (roofline, jroofline):
        buf = io.StringIO()
        mod.report_rows(rows, 3350.0, 3000.0, out=buf)
        mod.fit_op_cost(rows, out=buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "fit" in outs[0] and "R^2" in outs[0]
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert roofline.main([str(path)]) == 0
    assert "ceiling" in buf.getvalue() and "achieved" in buf.getvalue()


# ---- profile capture ---------------------------------------------------------------------


def test_profile_capture_records_artifact_and_overhead(tmp_path):
    from heat3d_tpu_torch.utils.timing import maybe_profile

    led = str(tmp_path / "led.jsonl")
    obs.activate(led)
    pdir = str(tmp_path / "trace")
    with maybe_profile(pdir, cuda=False):
        with obs.named_phase("stencil"):
            (torch.zeros(64) + 1).sum()
    obs.deactivate()
    (e,) = [e for e in _read(led) if e["event"] == "profile_capture"]
    assert e["ok"] is True and e["dir"] == pdir
    assert e["enter_overhead_s"] >= 0 and e["exit_overhead_s"] >= 0
    assert e["artifact"].endswith(".pt.trace.json") and os.path.exists(e["artifact"])
    trace = timeline.load_trace(e["artifact"])
    names = {ev.get("name") for ev in trace["traceEvents"] if ev.get("cat") == "user_annotation"}
    assert "heat3d.stencil" in names
    gauge = obs.REGISTRY.gauge("profile_capture_overhead_seconds")
    assert gauge.value(ok="true") == pytest.approx(e["enter_overhead_s"] + e["exit_overhead_s"])


def test_profile_capture_fails_soft(tmp_path, capsys):
    from heat3d_tpu_torch.obs.perf.profiling import profile_capture

    led = str(tmp_path / "led.jsonl")
    obs.activate(led)
    ran = []
    bad = tmp_path / "notadir"
    bad.write_text("x")
    with profile_capture(str(bad), cuda=False):
        ran.append(True)
    with profile_capture(str(tmp_path / "trace2"), cuda=False):
        (torch.zeros(4) + 1).sum()
    obs.deactivate()
    assert ran == [True] and "degraded" in capsys.readouterr().err
    evs = [e for e in _read(led) if e["event"] == "profile_capture"]
    assert [e["ok"] for e in evs] == [False, True] and "error" in evs[0]


def test_profile_capture_noop_without_dir():
    from heat3d_tpu_torch.obs.perf.profiling import profile_capture

    with profile_capture(None):
        pass
    with profile_capture(""):
        pass


def test_named_phase_ranges_only_while_profiling():
    """Without a profiler a phase range is a flag read (no
    record_function); on a CPU build it never touches NVTX."""
    from heat3d_tpu_torch.obs import trace

    ph = trace.named_phase("stencil")
    assert ph.name == "heat3d.stencil"
    with ph:
        assert ph._rf is None
    assert trace._hooks()[2] is None
    calls = []
    wrapped = trace.scoped("step", lambda x: calls.append(x) or x)
    assert wrapped(3) == 3 and calls == [3]


def test_cli_profile_window_and_phases(tmp_path):
    """``--profile`` on the CPU: the capture brackets warmup and the timed
    loop, and every phase range of the step lands in it."""
    from heat3d_tpu_torch.cli import main

    led, pdir = str(tmp_path / "led.jsonl"), str(tmp_path / "prof")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["--grid", "16", "--mesh", "2", "2", "2", "--device", "cpu", "--steps",
                     "3", "--ledger", led, "--profile", pdir]) == 0
    (cap,) = [e for e in _read(led) if e["event"] == "profile_capture"]
    assert cap["ok"]
    trace = timeline.load_trace(cap["artifact"])
    names = {ev.get("name") for ev in trace["traceEvents"] if ev.get("cat") == "user_annotation"}
    assert {"heat3d.warmup", "heat3d.run_loop", "heat3d.step", "heat3d.halo_exchange",
            "heat3d.halo.x", "heat3d.stencil", "heat3d.residual"} <= names


# ---- the timeline: torch traces ---------------------------------------------------------


def _x(cat, name, ts, dur, pid, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid, "args": args}


def synthetic_trace():
    """A torch Chrome trace with a known answer: host ranges on thread
    (100, 1), launches joined by correlation, device work on two streams of
    device 0, one event joined only through its stream's device-side range,
    and one launched after the timed window."""
    H, D = (100, 1), 0
    ev = [
        _x("user_annotation", "heat3d.run_loop", 0, 1000, *H),
        _x("user_annotation", "heat3d.step", 10, 190, *H),
        _x("user_annotation", "heat3d.halo_exchange", 20, 40, *H),
        _x("user_annotation", "heat3d.halo.x", 25, 15, *H),
        _x("user_annotation", "heat3d.stencil", 70, 80, *H),
        _x("user_annotation", "heat3d.residual", 160, 30, *H),
        _x("cpu_op", "aten::copy_", 250, 200, *H),
        _x("cpu_op", "aten::add", 300, 10, *H),
    ]
    launches = [(1, 30, "cuda_runtime"), (2, 50, "cuda_runtime"), (3, 80, "cuda_driver"),
                (4, 90, "cuda_runtime"), (5, 170, "cuda_runtime"), (6, 195, "cuda_runtime"),
                (7, 5, "cuda_runtime"), (8, 1100, "cuda_runtime")]
    for corr, t, cat in launches:
        ev.append(_x(cat, "cudaLaunchKernel", t, 2, *H, correlation=corr))
    device = [  # (corr, cat, name, ts, dur, stream)
        (1, "gpu_memcpy", "Memcpy DtoD", 100, 10, 7),
        (2, "gpu_memcpy", "Memcpy DtoD", 105, 10, 8),
        (3, "kernel", "direct_kernel<float, 1>", 120, 100, 7),
        (4, "kernel", "direct_kernel<float, 1>", 230, 30, 8),
        (5, "kernel", "reduce_kernel", 300, 10, 7),
        (6, "gpu_memset", "Memset", 310, 2, 7),
        (7, "kernel", "fill_kernel", 50, 5, 7),
        (8, "kernel", "late_kernel", 2000, 50, 7),
        (99, "kernel", "direct_kernel<float, 1>", 400, 20, 7),
    ]
    for corr, cat, name, ts, dur, stream in device:
        ev.append(_x(cat, name, ts, dur, D, stream, correlation=corr, stream=stream))
    ev.append(_x("gpu_user_annotation", "heat3d.run_loop", 40, 400, D, 7))
    ev.append(_x("gpu_user_annotation", "heat3d.stencil", 395, 35, D, 7))
    return {"schemaVersion": 1, "traceEvents": ev}


def test_device_activity_known_answer():
    act = timeline.device_activity(synthetic_trace())
    assert act["phase_us"] == {"halo_exchange": 20.0, "stencil": 150.0, "residual": 10.0,
                               "step": 2.0, "run_loop": 5.0}
    assert act["assigned"] == {"correlation": 8, "stream": 1, "none": 0}
    # the union over both streams: 5 + 15 + 100 + 30 + 12 + 20
    assert act["busy_us"] == 182.0 and act["window_us"] == 370.0
    assert act["busy_share"] == pytest.approx(182.0 / 370.0)
    assert [g["us"] for g in act["gaps"]] == [88.0, 45.0, 40.0, 10.0, 5.0]
    assert act["gaps"][0]["host_range"] == "heat3d.run_loop"
    assert act["gaps"][0]["host_op"] == "aten::copy_"
    assert act["kernels"]["direct_kernel<float, 1>"] == {"us": 150.0, "count": 3}
    assert act["events"] == 8 and act["host_ranges"] == 5


def test_device_phase_totals_window_and_fallback():
    tr = synthetic_trace()
    everything = timeline.device_phase_totals(tr)
    assert "late_kernel" not in str(everything)
    assert everything[timeline.UNATTRIBUTED] == 50.0  # the late launch
    assert timeline.device_phase_totals(tr, window=True) == timeline.device_activity(tr)[
        "phase_us"]
    assert timeline.normalize_phase("heat3d.halo.z.lo") == "halo_exchange"
    assert timeline.normalize_phase("heat3d.step") == "step"
    assert timeline.phase_name("heat3d.py:301 run") is None
    assert timeline.phase_name("heat3d.halo.x") == "heat3d.halo.x"


def test_profile_phase_totals_reads_a_capture_dir(tmp_path):
    d = tmp_path / "prof"
    d.mkdir()
    (d / "heat3d-1-2.pt.trace.json").write_text(json.dumps(synthetic_trace()))
    totals, artifact = timeline.profile_phase_totals(str(d))
    assert artifact.endswith(".pt.trace.json") and totals["stencil"] == 150.0
    assert timeline.device_activity(timeline.load_trace(artifact))["busy_us"] == 182.0
    assert timeline.profile_phase_totals(artifact)[0] == totals
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="no .pt.trace.json"):
        timeline.profile_phase_totals(str(tmp_path / "empty"))


def test_roofline_from_profile_join(tmp_path, capsys):
    d = tmp_path / "prof"
    d.mkdir()
    (d / "t.pt.trace.json").write_text(json.dumps(synthetic_trace()))
    rc = roofline.main(["--from-profile", str(d), "--grid", "16", "--steps", "4", "--json"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["steps"] == 4
    by = {r["phase"]: r for r in rep["phases"]}
    stencil = by["stencil"]
    assert stencil["device_us"] == 150.0 and stencil["calls"] == 4
    assert stencil["seconds"] == pytest.approx(150e-6 / 4)
    assert stencil["gbps"] == pytest.approx(stencil["bytes"] / stencil["seconds"] / 1e9)
    assert by["step"].get("seconds") is None
    assert roofline.main(["--from-profile", str(tmp_path / "empty"), "--grid", "16"]) == 1


# ---- the timeline: ledgers, merged streams, anomalies (against the JAX package) ----------


def _fixture_ledger_events():
    evs = []
    t0 = 1000.0

    def point(name, ts, **f):
        evs.append({"ts": ts, "run_id": "r1", "proc": 0, "seq": len(evs), "event": name,
                    "kind": "point", **f})

    def span(name, start, dur, **f):
        evs.append({"ts": start + dur, "run_id": "r1", "proc": 0, "seq": len(evs),
                    "event": name, "kind": "span", "t0": 5.0 + (start - t0),
                    "t1": 5.0 + (start - t0) + dur, "dur_s": dur, "depth": 0, "status": "ok",
                    **f})

    point("run_start", t0)
    span("warmup", t0 + 0.5, 0.25)
    span("chunk", t0 + 1.0, 0.4, steps=4)
    span("chunk", t0 + 1.5, 0.4, steps=4)
    point("run_summary", t0 + 2.0)
    return evs


def test_timeline_chrome_trace_golden():
    tl = timeline.timeline_events(_fixture_ledger_events())
    totals = {"stencil": 800.0, "halo_exchange": 200.0}
    doc = timeline.to_chrome_trace(tl, profile_totals=totals)
    assert doc == jtimeline.to_chrome_trace(jtimeline.timeline_events(
        _fixture_ledger_events()), profile_totals=totals)
    x = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    warm = next(e for e in x if e["name"] == "warmup")
    assert warm["ts"] == pytest.approx(0.5e6) and warm["dur"] == pytest.approx(0.25e6)
    prof = {e["name"]: e["dur"] for e in x if e["name"] in totals}
    assert prof == totals


def test_timeline_cli_writes_trace_and_json(tmp_path, capsys):
    led = tmp_path / "led.jsonl"
    led.write_text("".join(json.dumps(e) + "\n" for e in _fixture_ledger_events()))
    out = tmp_path / "trace.json"
    assert timeline.main([str(led), "-o", str(out), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["events"] == 5 and rep["spans"] == 3 and rep["out"] == str(out)
    assert timeline.main([str(tmp_path / "nope.jsonl"), "--json"]) == 2


def _chunk_span(dur, steps=4, proc=0, src="", seq=0, ts=0.0, run_id="r1"):
    e = {"ts": ts, "run_id": run_id, "proc": proc, "seq": seq, "event": "chunk",
         "kind": "span", "t0": 0.0, "t1": dur, "dur_s": dur, "depth": 0, "status": "ok",
         "steps": steps}
    if src:
        e["src"] = src
    return e


def _same_anomalies(evs, **kw):
    a = timeline.detect_anomalies(evs, **kw)
    assert a == jtimeline.detect_anomalies(evs, **kw)
    return a


def test_drift_detector_flags_injected_slowdown():
    evs = [_chunk_span(0.4, seq=i, ts=float(i)) for i in range(6)]
    evs += [_chunk_span(0.8, seq=6 + i, ts=6.0 + i) for i in range(3)]
    drifts = [a for a in _same_anomalies(evs) if a["kind_"] == "span_drift"]
    assert len(drifts) == 3
    for a in drifts:
        assert a["status"] == "fail" and a["delta_pct"] == pytest.approx(100.0, abs=0.1)
        assert a["baseline_s"] == pytest.approx(0.1) and a["per_step"] is True
    assert _same_anomalies([_chunk_span(0.4, seq=i, ts=float(i)) for i in range(10)]) == []


def test_drift_detector_warn_band_and_custom_tolerance():
    evs = [_chunk_span(0.4, seq=i, ts=float(i)) for i in range(6)]
    evs.append(_chunk_span(0.44, seq=6, ts=6.0))
    assert [a["status"] for a in _same_anomalies(evs)] == ["warn"]
    assert _same_anomalies(evs, warn_pct=20.0, fail_pct=30.0) == []


def test_drift_detector_never_crosses_run_boundaries():
    evs = [_chunk_span(0.4, seq=i, ts=float(i), run_id="run-a") for i in range(6)]
    evs += [_chunk_span(2.0, seq=6 + i, ts=6.0 + i, run_id="run-b") for i in range(6)]
    assert _same_anomalies(evs) == []
    evs.append(_chunk_span(4.0, seq=12, ts=12.0, run_id="run-b"))
    anoms = _same_anomalies(evs)
    assert [a["status"] for a in anoms] == ["fail"] and anoms[0]["run_id_"] == "run-b"


def test_straggler_detector_on_merged_streams(tmp_path):
    from heat3d_tpu_torch.obs.check import main as check_main

    evs = []
    for i in range(5):
        for src, dur in (("h0.jsonl", 0.4), ("h1.jsonl", 0.4), ("h2.jsonl", 0.8)):
            evs.append(_chunk_span(dur, src=src, seq=i, ts=float(i)))
    anoms = _same_anomalies(evs)
    (s,) = [a for a in anoms if a["kind_"] == "host_straggler"]
    assert s["src"] == "h2.jsonl" and s["status"] == "fail"
    led = str(tmp_path / "anom.jsonl")
    obs.activate(led, meta={"entry": "test"})
    timeline.emit_anomalies(anoms)
    obs.deactivate(rc=0)
    assert len([e for e in _read(led) if e["event"] == "obs_anomaly"]) == len(anoms)
    assert check_main(["--taxonomy", led]) == 0


def test_summary_prints_anomaly_section(tmp_path, capsys):
    from heat3d_tpu_torch.obs.cli import main as obs_main

    led = tmp_path / "led.jsonl"
    evs = [_chunk_span(0.4, seq=i, ts=float(i)) for i in range(6)]
    evs.append(_chunk_span(1.0, seq=6, ts=6.0))
    led.write_text("".join(json.dumps(e) + "\n" for e in evs))
    assert obs_main(["summary", str(led)]) == 0
    out = capsys.readouterr().out
    assert "ANOMALY" in out and "chunk" in out


def test_summary_roofline_sections(tmp_path, capsys):
    from heat3d_tpu.obs.cli import main as jax_main
    from heat3d_tpu_torch.obs.cli import main as obs_main

    led = str(tmp_path / "led.jsonl")
    ledger = obs.activate(led)
    ledger.event("step_cost", ok=True, platform="cpu", cost_flops_per_step=2.0e9,
                 cost_bytes_per_step=4.0e9)
    with ledger.span("run_loop") as sp:
        sp.add(steps=10)
    ledger.event("bench_row", bench="halo", platform="cpu", grid=[32, 32, 32], p50_us=100.0,
                 cost_bytes_per_step=2.0e6)
    ledger.event("bench_row", bench="halo", platform="cpu", grid=[16, 16, 16], p50_us=5.0,
                 cost_bytes_per_step=2.0e6, rtt_dominated=True)
    ledger.event("bench_row", bench="throughput", platform="cpu", grid=[32, 32, 32],
                 time_blocking=4, steps=10, seconds_best=0.1, cost_flops_per_step=1.0e9,
                 cost_bytes_per_step=2.0e9, cost_redundant_flops_frac=0.25)
    obs.deactivate()
    outs = []
    for main in (obs_main, jax_main):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert main(["summary", led]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    out = outs[0]
    assert "roofline run_loop [cpu]" in out
    assert "roofline halo 32x32x32 p50 [cpu]" in out and "20.00 GB/s" in out
    assert "halo 16x16x16" not in out and "tb=4 (25% recompute)" in out


# ---- multi-process ledger merge --------------------------------------------------------


def _fake_ledger(path, proc, skew, events=("ledger_open", "run_start", "run_summary")):
    with open(path, "w") as f:
        for i, ev in enumerate(events):
            f.write(json.dumps({"ts": 1000.0 + skew + i, "run_id": f"run{proc}",
                                "proc": proc, "seq": i, "event": ev, "kind": "point"}) + "\n")


def test_merge_timeline_and_skew_equal_jax(tmp_path):
    p0, p1 = str(tmp_path / "p0.jsonl"), str(tmp_path / "p1.jsonl")
    _fake_ledger(p0, 0, 0.0)
    _fake_ledger(p1, 1, 2.5)
    result = merge_ledgers([p0, p1])
    assert result == jmerge.merge_ledgers([p0, p1])
    assert [e["ts"] for e in result["events"]] == sorted(e["ts"] for e in result["events"])
    stats = result["stats"]
    assert stats["anchor_event"] == "run_start"
    assert stats["max_skew_s"] == pytest.approx(2.5)
    aligned = merge_ledgers([p0, p1], align=True)
    assert aligned == jmerge.merge_ledgers([p0, p1], align=True)


def test_merge_cli_writes_lintable_file(tmp_path, capsys):
    from heat3d_tpu_torch.obs import check as ledger_check

    p0, p1 = str(tmp_path / "p0.jsonl"), str(tmp_path / "p1.jsonl")
    _fake_ledger(p0, 0, 0.0)
    _fake_ledger(p1, 1, 0.5)
    out = str(tmp_path / "merged.jsonl")
    assert merge.main([p0, p1, "-o", out, "--json"]) == 0
    assert json.loads(capsys.readouterr().out.strip())["total_events"] == 6
    assert ledger_check.check_file(out) == []


def test_merge_missing_anchor_degrades(tmp_path):
    p0, p1 = str(tmp_path / "p0.jsonl"), str(tmp_path / "p1.jsonl")
    _fake_ledger(p0, 0, 0.0, events=("ledger_open", "run_start"))
    _fake_ledger(p1, 1, 1.0, events=("ledger_open",))
    stats = merge_ledgers([p0, p1])["stats"]
    assert stats["anchor_event"] == "ledger_open"
    assert stats["max_skew_s"] == pytest.approx(1.0)


def test_chip_smoke_keeps_no_copy_of_the_yardstick():
    """``chip_smoke.py`` takes every bound from ``obs.perf.roofline``."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    for name in ("flops_per_update", "bound_ms", "kernel_bound",
                 "superstep_bound", "fused_bound", "sharded_superstep_bound",
                 "halo_exchange_bytes", "bandwidth"):
        assert getattr(chip_smoke, name) is getattr(roofline, name), name

"""The port's observability package on the CPU (``heat3d_tpu_torch.obs``),
held to the JAX package's ``heat3d_tpu.obs``: the JAX ``tests/test_obs.py``
cases the port covers (ledger, metrics, the ledger lint, the obs CLI, the
instrumented resilience and checkpoint modules), the ``tests/test_obs_live.py``
tail/check cases, and the two packages side by side: the solver CLI's
``--ledger`` on ``--device cpu`` lints clean under both lints with the
taxonomy on and has the JAX CLI's event and span sequence; ``obs summary``,
``obs tail`` and ``obs timeline`` print the same over one ledger; the two
metrics registries give the same Prometheus text."""

import contextlib
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from heat3d_tpu import obs as jobs
from heat3d_tpu.analysis import ledgerlint as jax_ledgerlint
from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig
from heat3d_tpu_torch.obs import check as ledger_check
from heat3d_tpu_torch.obs.ledger import Ledger
from heat3d_tpu_torch.obs.metrics import MetricsRegistry

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def _isolated_obs(tmp_path, monkeypatch):
    """Every test starts and ends with no active ledger in either package,
    and a tuning store of its own (the roofline's calibrated-peak lookup
    reads it)."""
    monkeypatch.delenv("HEAT3D_LEDGER", raising=False)
    monkeypatch.delenv("HEAT3D_METRICS", raising=False)
    monkeypatch.setenv("HEAT3D_TUNE_CACHE", str(tmp_path / "tune.json"))
    obs.deactivate()
    jobs.deactivate()
    yield
    obs.deactivate()
    jobs.deactivate()


def _read(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def _envelope(seq, event="e", kind="point", run_id="r1", **extra):
    rec = {"ts": 100.0 + seq, "run_id": run_id, "proc": 0, "seq": seq,
           "event": event, "kind": kind}
    rec.update(extra)
    return rec


def _write_ledger(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


# ---- ledger ------------------------------------------------------------------


def test_ledger_events_spans_and_context(tmp_path):
    p = str(tmp_path / "led.jsonl")
    led = obs.activate(p, meta={"entry": "test"})
    assert obs.get() is led and led.active
    led.set_context(generation=4)
    led.event("run_start", grid=[8, 8, 8])
    with led.span("outer", steps=2) as sp:
        with led.span("inner"):
            pass
        sp.add(note="x")
    assert sp.dur_s is not None and sp.dur_s >= 0
    with pytest.raises(RuntimeError, match="boom"):
        with led.span("fails"):
            raise RuntimeError("boom")
    obs.deactivate(rc=0)
    evs = _read(p)
    names = [e["event"] for e in evs]
    assert names == ["ledger_open", "run_start", "inner", "outer", "fails", "ledger_close"]
    for e in evs:
        for f in ("ts", "run_id", "proc", "seq", "event", "kind"):
            assert f in e
    assert all(e["generation"] == 4 for e in evs[1:])
    assert evs[0]["schema"] == 1 and evs[0]["entry"] == "test" and evs[0]["proc"] == 0
    outer, inner = evs[names.index("outer")], evs[names.index("inner")]
    assert inner["seq"] < outer["seq"]
    assert outer["t0"] <= inner["t0"] and inner["t1"] <= outer["t1"]
    assert outer["depth"] == 0 and inner["depth"] == 1
    assert outer["note"] == "x" and outer["steps"] == 2
    failed = evs[names.index("fails")]
    assert failed["status"] == "error" and "boom" in failed["error"]
    assert ledger_check.check_file(p) == []
    assert ledger_check.main([p]) == 0
    # the JAX lint reads the port's ledger the same way
    assert jax_ledgerlint.check_file(p) == []


def test_ledger_null_when_unconfigured_and_env_activation(tmp_path, monkeypatch):
    led = obs.get()
    assert not led.active
    led.event("ignored")
    with led.span("ignored") as sp:
        pass
    assert sp.dur_s is not None
    p = str(tmp_path / "env.jsonl")
    monkeypatch.setenv("HEAT3D_LEDGER", p)
    obs.deactivate()
    led2 = obs.get()
    assert led2.active
    led2.event("hello")
    obs.deactivate()
    assert [e["event"] for e in _read(p)] == ["ledger_open", "hello", "ledger_close"]


def test_process_index_without_a_process_group():
    """``proc`` is the torch.distributed rank when a group is up, else 0,
    and asking never initializes CUDA."""
    from heat3d_tpu_torch.obs.ledger import _process_index

    assert _process_index() == 0
    assert not torch.cuda.is_initialized()


def test_process_index_in_a_gloo_group(tmp_path):
    import torch.distributed as dist

    from heat3d_tpu_torch.obs.ledger import _process_index

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}",
                            rank=0, world_size=1)
    try:
        assert _process_index() == 0 and dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_ledger_unserializable_span_field_salvaged_schema_valid(tmp_path):
    p = str(tmp_path / "l.jsonl")
    led = Ledger(p)
    circular: dict = {}
    circular["self"] = circular
    with led.span("chunk", steps=2, bad=circular):
        pass
    led.event("point_bad", bad=circular, fine=1)
    led.close()
    evs = _read(p)
    chunk = next(e for e in evs if e["event"] == "chunk")
    assert chunk["kind"] == "span" and chunk["status"] == "ok"
    assert chunk["malformed_fields"] == ["bad"] and chunk["steps"] == 2
    pt = next(e for e in evs if e["event"] == "point_bad")
    assert pt["fine"] == 1 and "bad" not in pt
    assert ledger_check.check_file(p) == []


def test_metrics_export_unwritable_path_does_not_raise(tmp_path, monkeypatch):
    from heat3d_tpu_torch.obs.metrics import export_at_exit

    blocker = tmp_path / "blocker"
    blocker.write_text("")
    monkeypatch.setenv("HEAT3D_METRICS", str(blocker / "m.json"))
    assert export_at_exit() is None


def test_check_ledger_start_line_scopes_report(tmp_path):
    p = str(tmp_path / "l.jsonl")
    _write_ledger(p, [_envelope(0, "orphan", run_id="dead"),
                      _envelope(0, "ledger_open", run_id="r9"),
                      _envelope(1, "fine", run_id="r9")])
    assert ledger_check.main([p]) == 1
    assert ledger_check.main(["--start-line", "2", p]) == 0


def test_ledger_envelope_fields_never_clobbered(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    led.event("x", seq=999, run_id="fake", kind="span")
    led.close()
    x = _read(led.path)[1]
    assert x["seq"] == 1 and x["run_id"] == led.run_id and x["kind"] == "point"


def test_ledger_fails_soft_never_kills_the_run(tmp_path, capsys):
    blocker = tmp_path / "f"
    blocker.write_text("")
    led = obs.activate(str(blocker / "led.jsonl"))
    assert not led.active
    led.event("still_fine")
    assert "running without one" in capsys.readouterr().err
    p = str(tmp_path / "l.jsonl")
    led2 = Ledger(p)
    led2.event("before")
    real_f = led2._f

    def die(_):
        raise OSError(28, "No space left on device")

    led2._f = SimpleNamespace(closed=False, write=die, flush=lambda: None,
                              close=real_f.close)
    led2.event("after")
    assert "disabled" in capsys.readouterr().err
    led2._f = real_f
    led2.event("later")
    led2.close()
    assert [e["event"] for e in _read(p)] == ["ledger_open", "before"]


def test_rotation_rolls_segments_and_reads_back_whole(tmp_path, monkeypatch):
    from heat3d_tpu_torch.obs.cli import read_ledger
    from heat3d_tpu_torch.obs.ledger import ledger_segments

    monkeypatch.setenv("HEAT3D_LEDGER_MAX_MB", "0.002")  # 2 kB segments
    p = str(tmp_path / "led.jsonl")
    led = obs.activate(p)
    for i in range(60):
        led.event("tick", i=i, pad="x" * 40)
    obs.deactivate()
    segs = ledger_segments(p)
    assert len(segs) > 2 and segs[-1] == p
    ticks = [e["i"] for e in read_ledger(p) if e["event"] == "tick"]
    assert ticks == list(range(60))
    assert ledger_check.check_file(p) == []


# ---- metrics -------------------------------------------------------------------


def test_metrics_counter_gauge_histogram_and_snapshot():
    reg = MetricsRegistry()
    c = reg.counter("retries_total", "help text")
    c.inc()
    c.inc(2, reason="deadline")
    with pytest.raises(ValueError):
        c.inc(-1)
    reg.gauge("rtt_seconds").set(0.075, backend="cuda")
    h = reg.histogram("lat_seconds")
    for v in [1.0, 2.0, 3.0, 4.0, 100.0]:
        h.observe(v)
    snap = reg.snapshot()
    assert snap["heat3d_retries_total"]["values"][""] == 1
    assert snap["heat3d_retries_total"]["values"]['{reason="deadline"}'] == 2
    st = snap["heat3d_lat_seconds"]["values"][""]
    assert st["count"] == 5 and st["min"] == 1.0 and st["max"] == 100.0
    assert st["p50"] == 3.0 and st["p95"] == 100.0
    with pytest.raises(TypeError):
        reg.gauge("retries_total")


def test_metrics_prometheus_text_and_files(tmp_path):
    reg = MetricsRegistry()
    reg.counter("a_total", "things").inc(3)
    reg.histogram("lat_seconds").observe(2.0)
    text = reg.to_prometheus_text()
    assert "# TYPE heat3d_a_total counter" in text and "heat3d_a_total 3.0" in text
    assert 'heat3d_lat_seconds{quantile="0.5"} 2.0' in text
    prom = tmp_path / "m.prom"
    reg.write_snapshot(str(prom))
    assert prom.read_text() == text
    js = tmp_path / "m.json"
    reg.write_snapshot(str(js))
    assert json.loads(js.read_text())["heat3d_a_total"]["kind"] == "counter"


def test_histogram_cap_marks_clipped():
    from heat3d_tpu_torch.obs.metrics import HISTOGRAM_SAMPLE_CAP

    h = MetricsRegistry().histogram("big")
    for i in range(HISTOGRAM_SAMPLE_CAP + 10):
        h.observe(float(i))
    st = h.stats()
    assert st["count"] == HISTOGRAM_SAMPLE_CAP + 10 and st["clipped"] is True


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("retry_attempts_total", "RetryPolicy attempts").inc(ok="false")
    reg.counter("retry_attempts_total", "RetryPolicy attempts").inc(2, ok="true")
    reg.gauge("sync_rtt_seconds", "measured force_sync host round trip").set(
        1.5e-5, backend="x")
    h = reg.histogram("step_latency_seconds", "per-step wall latency")
    for v in (0.004, 0.002, 0.003, 0.010, 0.001, 0.0025):
        h.observe(v)
    big = reg.histogram("halo_exchange_latency_seconds")
    for i in range(mod.HISTOGRAM_SAMPLE_CAP + 3):
        big.observe(i * 1e-6)
    return reg


def test_metrics_prometheus_text_equals_jax():
    """The same operations through both registries give the same
    Prometheus text and the same JSON snapshot."""
    from heat3d_tpu.obs import metrics as jmetrics
    from heat3d_tpu_torch.obs import metrics as pmetrics

    a, b = _drive_registry(pmetrics), _drive_registry(jmetrics)
    assert a.to_prometheus_text() == b.to_prometheus_text()
    assert a.snapshot() == b.snapshot()


def test_percentile_has_one_home():
    """``utils.timing.percentile`` is the obs one, not a second copy."""
    from heat3d_tpu_torch.obs.metrics import percentile
    from heat3d_tpu_torch.utils import timing

    assert timing.percentile is percentile
    assert percentile([5.0, 1.0, 3.0], 50) == 3.0


# ---- the ledger lint -------------------------------------------------------------


def test_check_ledger_catches_seeded_defects(tmp_path):
    p = str(tmp_path / "bad.jsonl")
    span = dict(t0=1.0, t1=2.0, dur_s=1.0, depth=0, status="ok")
    _write_ledger(p, [
        _envelope(0, "ledger_open"),
        _envelope(1, "ok_span", kind="span", **span),
        {k: v for k, v in _envelope(2).items() if k != "run_id"},
        _envelope(3, kind="bogus"),
        _envelope(4, "torn", kind="span", t0=5.0, t1=4.0, dur_s=-1.0, depth=0, status="ok"),
        _envelope(2),
        _envelope(90, "orphan", run_id="r2"),
    ])
    msgs = [m for _, m in ledger_check.check_file(p)]
    assert any("missing required field 'run_id'" in m for m in msgs)
    assert any("not 'point' or 'span'" in m for m in msgs)
    assert any("ends before it starts" in m for m in msgs)
    assert any("not above seq" in m for m in msgs)
    assert any("no ledger_open" in m for m in msgs)
    assert ledger_check.main([p]) == 1
    # the same defects, line for line, as the JAX lint finds
    assert ledger_check.check_file(p) == jax_ledgerlint.check_file(p)


def test_check_ledger_span_nesting_rule(tmp_path):
    def spans(path, bounds):
        recs = [_envelope(0, "ledger_open")]
        for i, (t0, t1) in enumerate(bounds, start=1):
            recs.append(_envelope(i, f"s{i}", kind="span", t0=t0, t1=t1, dur_s=t1 - t0,
                                  depth=0, status="ok"))
        _write_ledger(path, recs)

    ok = str(tmp_path / "nested.jsonl")
    spans(ok, [(1.0, 2.0), (2.5, 6.0), (3.0, 4.0), (3.2, 3.8)])
    assert ledger_check.check_file(ok) == []
    bad = str(tmp_path / "overlap.jsonl")
    spans(bad, [(1.0, 3.0), (2.0, 4.0)])
    assert any("partially overlaps" in m for _, m in ledger_check.check_file(bad))


def test_taxonomy_flags_unregistered_names_and_kinds(tmp_path):
    p = str(tmp_path / "tax.jsonl")
    _write_ledger(p, [_envelope(0, "ledger_open"), _envelope(1, "no_such_event"),
                      _envelope(2, "run_loop")])  # a span name as a point
    msgs = [m for _, m in ledger_check.check_file(p, taxonomy=True)]
    assert any("not in the canonical registry" in m for m in msgs)
    assert any("run_loop" in m for m in msgs)
    assert ledger_check.check_file(p) == []


def test_port_registry_covers_the_jax_registry():
    """The port's event registry is the JAX one (every name, the same
    kind), so one taxonomy lint holds both packages' ledgers."""
    from heat3d_tpu.analysis.registry import LEDGER_EVENTS as JAX_EVENTS
    from heat3d_tpu_torch.analysis.registry import LEDGER_EVENTS

    assert set(JAX_EVENTS) <= set(LEDGER_EVENTS)
    assert all(LEDGER_EVENTS[k]["kind"] == v["kind"] for k, v in JAX_EVENTS.items())


def test_stream_checker_flags_defects_once(tmp_path):
    from heat3d_tpu_torch.analysis.ledgerlint import StreamChecker

    sc = StreamChecker(taxonomy=True)
    first = []
    for rec in (_envelope(0, "ledger_open"), _envelope(1, "bogus_name"),
                _envelope(1, "run_start")):
        first += sc.feed(json.dumps(rec))
    again = sc.feed(json.dumps(_envelope(2, "run_start")))
    assert any("canonical registry" in m for _, m in first)
    assert any("not above seq" in m for _, m in first)
    assert again == [] and sc.lines_seen == 4


# ---- the obs CLI -------------------------------------------------------------------


def test_obs_cli_summary_tail_check(tmp_path, capsys):
    from heat3d_tpu_torch.cli import main as heat3d_main

    p = str(tmp_path / "led.jsonl")
    led = obs.activate(p)
    led.event("run_start", grid=[8, 8, 8])
    for n in (4, 4, 2):
        with led.span("steps", steps=n):
            pass
    obs.deactivate()
    assert heat3d_main(["obs", "check", p]) == 0
    capsys.readouterr()
    assert heat3d_main(["obs", "summary", p]) == 0
    out = capsys.readouterr().out
    assert "run_start" in out and "steps" in out and "step latency" in out
    assert heat3d_main(["obs", "tail", p, "-n", "2"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_obs_cli_step_latency_reconstruction():
    from heat3d_tpu_torch.obs.cli import step_latencies

    events = [
        {"kind": "span", "event": "chunk", "status": "ok", "steps": 4, "dur_s": 0.4},
        {"kind": "span", "event": "chunk", "status": "ok", "steps": 2, "dur_s": 0.1},
        {"kind": "span", "event": "chunk", "status": "error", "steps": 4, "dur_s": 9.9},
        {"kind": "span", "event": "ckpt_save", "status": "ok", "dur_s": 1.0},
        {"kind": "point", "event": "chunk", "steps": 4},
    ]
    assert step_latencies(events) == [0.1, 0.05]


def test_tail_follow_and_check_follow(tmp_path, capsys):
    from heat3d_tpu_torch.obs.cli import main as obs_main

    p = str(tmp_path / "led.jsonl")
    led = obs.activate(p)
    led.event("run_start", grid=[8, 8, 8])
    obs.deactivate()
    assert obs_main(["tail", p, "--follow", "--duration", "0.2", "--interval", "0.05"]) == 0
    assert "run_start" in capsys.readouterr().out
    assert obs_main(["check", p, "--follow", "--duration", "0.2",
                     "--interval", "0.05", "--taxonomy"]) == 0


def test_tailer_is_incremental_and_buffers_partial_lines(tmp_path):
    from heat3d_tpu_torch.obs.tailer import LedgerTailer

    p = tmp_path / "led.jsonl"
    p.write_text(json.dumps(_envelope(0, "ledger_open")) + "\n")
    t = LedgerTailer(str(p))
    assert [r["event"] for r in t.poll()] == ["ledger_open"]
    with open(p, "a") as f:
        f.write(json.dumps(_envelope(1, "a"))[:10])
    assert t.poll() == []
    with open(p, "a") as f:
        f.write(json.dumps(_envelope(1, "a"))[10:] + "\n")
    assert [r["event"] for r in t.poll()] == ["a"]


# ---- the instrumented modules ---------------------------------------------------------


def test_retry_policy_writes_ledger_events(tmp_path):
    from heat3d_tpu_torch.resilience.retry import RetryPolicy

    p = str(tmp_path / "led.jsonl")
    obs.activate(p)
    calls = {"n": 0}

    def attempt():
        calls["n"] += 1
        return "up" if calls["n"] >= 3 else None

    outcome = RetryPolicy(max_attempts=5, base_delay_s=0.0, max_delay_s=0.0).run(attempt)
    obs.deactivate()
    assert outcome.ok
    evs = _read(p)
    attempts = [e for e in evs if e["event"] == "retry_attempt"]
    assert [a["ok"] for a in attempts] == [False, False, True]
    assert [e for e in evs if e["event"] == "retry_outcome"][-1]["stop_reason"] == "success"
    assert ledger_check.check_file(p, taxonomy=True) == []


def test_fault_injection_is_observable(tmp_path):
    from heat3d_tpu_torch.resilience.faults import FaultPlan, InjectedBackendLoss, _parse_spec

    p = str(tmp_path / "led.jsonl")
    obs.activate(p)
    obs.REGISTRY.reset()
    plan = FaultPlan(_parse_spec("backend-loss:step=8:down=1"))
    plan.on_step(4)
    with pytest.raises(InjectedBackendLoss):
        plan.on_step(8)
    plan.on_step(9)
    obs.deactivate()
    faults = [e for e in _read(p) if e["event"] == "fault_injected"]
    assert len(faults) == 1
    assert faults[0]["kind_"] == "backend-loss" and faults[0]["step"] == 8
    assert faults[0]["params"] == {"step": 8, "down": 1}
    snap = obs.REGISTRY.snapshot()
    assert snap["heat3d_faults_injected_total"]["values"]['{kind="backend-loss"}'] == 1


def test_checkpoint_save_load_quarantine_events(tmp_path):
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.resilience.faults import corrupt_one_shard
    from heat3d_tpu_torch.utils import checkpoint as ckpt

    p = str(tmp_path / "led.jsonl")
    obs.activate(p)
    obs.REGISTRY.reset()
    solver = HeatSolver3D(SolverConfig(grid=GridConfig.cube(8), backend="jnp"), device="cpu")
    u = solver.init_state("hot-cube")
    ck = str(tmp_path / "ck")
    solver.save_checkpoint(ck, u, 3)
    solver.load_checkpoint(ck)
    corrupt_one_shard(ck)
    with pytest.raises(ckpt.ShardCorruptError):
        solver.load_checkpoint(ck)
    ckpt.quarantine(ck, reason="test")
    obs.deactivate()
    evs = _read(p)
    names = [e["event"] for e in evs]
    for want in ("init_state", "ckpt_save", "ckpt_load", "ckpt_corrupt", "ckpt_quarantine"):
        assert want in names
    saves = [e for e in evs if e["event"] == "ckpt_save"]
    assert saves[0]["status"] == "ok" and saves[0]["step"] == 3
    assert saves[0]["shards"] == 1 and saves[0]["bytes"] == 8 ** 3 * 4
    loads = [e for e in evs if e["event"] == "ckpt_load"]
    assert loads[0]["status"] == "ok" and loads[0]["step"] == 3
    assert loads[-1]["status"] == "error"
    snap = obs.REGISTRY.snapshot()
    assert snap["heat3d_ckpt_writes_total"]["values"][""] == 1
    verify = snap["heat3d_ckpt_verify_total"]["values"]
    assert verify['{result="ok"}'] >= 1 and verify['{result="corrupt"}'] == 1
    assert snap["heat3d_ckpt_quarantine_total"]["values"][""] == 1
    assert ledger_check.check_file(p, taxonomy=True) == []


def test_backend_probe_span_and_counter(tmp_path):
    from heat3d_tpu_torch.utils import backendprobe

    p = str(tmp_path / "led.jsonl")
    obs.activate(p)
    obs.REGISTRY.reset()
    assert backendprobe._probe("print('cpu')", timeout=60) == "cpu"
    assert backendprobe._probe("raise SystemExit(1)", timeout=60) is None
    obs.deactivate()
    spans = [e for e in _read(p) if e["event"] == "backend_probe"]
    assert [(s["ok"], s["result"]) for s in spans] == [(True, "cpu"), (False, None)]
    values = obs.REGISTRY.snapshot()["heat3d_backend_probes_total"]["values"]
    assert values == {'{result="ok"}': 1, '{result="down"}': 1}


def test_cg_solve_event(tmp_path):
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    p = str(tmp_path / "led.jsonl")
    obs.activate(p)
    cfg = SolverConfig(grid=GridConfig.cube(8), integrator="implicit-cg")
    solver = HeatSolver3D(cfg, device="cpu")
    solver.run(solver.init_state("hot-cube"), 2)
    obs.deactivate()
    (cg,) = [e for e in _read(p) if e["event"] == "cg_solve"]
    assert cg["steps"] == 2 and (cg["cg_iters"], cg["cg_relres"]) == solver.last_cg_stats


def test_bench_row_event_respells_ts(tmp_path):
    """``bench_row`` mirrors a row; its UTC ``ts`` survives the envelope
    collision as ``ts_`` (the JAX rule)."""
    from heat3d_tpu_torch.bench import harness

    p = str(tmp_path / "led.jsonl")
    obs.activate(p)
    cfg = SolverConfig(grid=GridConfig.cube(16), mesh=MeshConfig(shape=(2, 1, 1)))
    row = harness.halo_row(cfg, k=4, iters=3, times=[1e-5, 2e-5, 3e-5],
                           devices=[torch.device("cpu")], shards=2, sync_rtt_s=1e-6)
    harness._ledger_bench_row(row)
    obs.deactivate()
    (ev,) = [e for e in _read(p) if e["event"] == "bench_row"]
    assert ev["ts_"] == row["ts"] and ev["p50_us"] == row["p50_us"]
    assert ev["cost_bytes_per_step"] == row["cost_bytes_per_step"] > 0
    assert ledger_check.check_file(p, taxonomy=True) == []


def test_run_suite_ledger_events(tmp_path, monkeypatch):
    """``run_suite``: a measured row is a ``bench_row_measure`` span, a
    journaled one a ``bench_row_replayed`` event, a row measured off the
    card ``bench_row_pending`` (and stays unjournaled)."""
    from heat3d_tpu_torch.bench import harness
    from heat3d_tpu_torch.resilience.sweepstate import SweepState

    monkeypatch.setattr(harness, "bench_throughput",
                        lambda cfg, steps, repeats, device: {"bench": "throughput",
                                                             "platform": "gpu"})
    monkeypatch.setattr(harness, "bench_halo",
                        lambda cfg, iters, device: {"bench": "halo", "platform": "cpu"})
    state = str(tmp_path / "sweep.jsonl")
    p = str(tmp_path / "led.jsonl")
    obs.activate(p)
    cfg = SolverConfig(grid=GridConfig.cube(16))
    harness.run_suite([cfg], steps=2, out=io.StringIO(), state_path=state)
    harness.run_suite([cfg], steps=2, out=io.StringIO(), state_path=state)
    obs.deactivate()
    names = [e["event"] for e in _read(p)]
    assert names.count("bench_row_measure") == 3  # tput, halo, then halo again
    assert names.count("bench_row_replayed") == 1
    assert names.count("bench_row_pending") == 2
    assert len(SweepState(state).keys()) == 1
    assert ledger_check.check_file(p, taxonomy=True) == []


def test_sync_rtt_gauge(monkeypatch):
    """``sync_rtt`` publishes the measured round trip as the
    ``sync_rtt_seconds`` gauge (stand-in device calls on the CPU)."""
    from heat3d_tpu_torch.utils import timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    zeros = torch.zeros
    monkeypatch.setattr(timing.torch, "zeros", lambda *a, **k: zeros(1))
    obs.REGISTRY.reset()
    rtt = timing.sync_rtt(samples=3)
    assert obs.REGISTRY.gauge("sync_rtt_seconds").value(backend="cuda") == rtt


# ---- the solver CLI's ledger, against the JAX CLI's ------------------------------------

# events of JAX modules this slice does not port: the tuning cache's
# resolution (tune/cache.py) and the process plan cache's audit
# (parallel/plan.py); the rest of the stream must match
JAX_ONLY_EVENTS = ("tune_cache_hit", "tune_cache_miss", "tune_cache_stale",
                   "exchange_plan_built", "plan_cache_hit")

CLI_CASES = [((1, 1, 1), 1), ((1, 1, 1), 2), ((2, 2, 2), 1), ((2, 2, 2), 2)]


def _port_cli_ledger(tmp_path, mesh, tb, extra=()):
    from heat3d_tpu_torch.cli import main

    p = str(tmp_path / f"port_{mesh[0]}_{tb}.jsonl")
    argv = ["--grid", "16", "--steps", "5", "--time-blocking", str(tb), "--mesh",
            *map(str, mesh), "--device", "cpu", "--ledger", p, *extra]
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv) == 0
    return p


def _jax_cli_ledger(tmp_path, mesh, tb, extra=()):
    p = str(tmp_path / f"jax_{mesh[0]}_{tb}.jsonl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               HEAT3D_TUNE_CACHE=str(tmp_path / "jax_tune.json"))
    env.pop("HEAT3D_LEDGER", None)
    argv = [sys.executable, "-m", "heat3d_tpu", "--grid", "16", "--steps", "5",
            "--time-blocking", str(tb), "--mesh", *map(str, mesh), "--ledger", p, *extra]
    out = subprocess.run(argv, env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return p


def _shape(path):
    return [(e["event"], e["kind"], e.get("depth")) for e in _read(path)
            if e["event"] not in JAX_ONLY_EVENTS]


@pytest.mark.parametrize("mesh,tb", CLI_CASES, ids=lambda v: str(v))
def test_cli_ledger_lints_clean_and_matches_jax(tmp_path, mesh, tb):
    port = _port_cli_ledger(tmp_path, mesh, tb)
    assert jax_ledgerlint.check_file(port, taxonomy=True) == []
    assert ledger_check.check_file(port, taxonomy=True) == []
    jax = _jax_cli_ledger(tmp_path, mesh, tb)
    assert _shape(port) == _shape(jax)
    evs = _read(port)
    cost = next(e for e in evs if e["event"] == "step_cost")
    assert cost["ok"] and cost["platform"] == "cpu"
    loop = next(e for e in evs if e["event"] == "run_loop")
    assert loop["steps"] == 5 and loop["status"] == "ok"
    res = [e for e in evs if e["event"] == "residual"]
    assert [r["step"] for r in res] == [5]
    close = evs[-1]
    assert close["event"] == "ledger_close" and close["rc"] == 0


def test_cli_ledger_residual_cadence_and_checkpoint_match_jax(tmp_path):
    """Residual points every K steps and a final checkpoint: the same
    events (``residual`` x3, ``ckpt_save``) in the same places."""
    extra = ["--residual-every", "2", "--checkpoint", str(tmp_path / "ck")]
    port = _port_cli_ledger(tmp_path, (1, 1, 1), 1, extra)
    extra_j = ["--residual-every", "2", "--checkpoint", str(tmp_path / "ckj")]
    jax = _jax_cli_ledger(tmp_path, (1, 1, 1), 1, extra_j)
    assert _shape(port) == _shape(jax)
    assert [e["step"] for e in _read(port) if e["event"] == "residual"] == [2, 4, 5]
    assert jax_ledgerlint.check_file(port, taxonomy=True) == []


def test_cli_config_error_closes_ledger_rc2(tmp_path):
    from heat3d_tpu_torch.cli import main

    p = str(tmp_path / "led.jsonl")
    assert main(["--grid", "16", "7", "--ledger", p, "--device", "cpu"]) == 2
    evs = _read(p)
    assert [e["event"] for e in evs] == ["ledger_open", "ledger_close"]
    assert evs[-1]["rc"] == 2 and "ValueError" in evs[-1]["error"]


def test_cli_run_writes_ledger_and_metrics_export(tmp_path, monkeypatch):
    from heat3d_tpu_torch.cli import main

    p = str(tmp_path / "led.jsonl")
    prom = str(tmp_path / "m.prom")
    monkeypatch.setenv("HEAT3D_METRICS", prom)
    obs.REGISTRY.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["--grid", "8", "--steps", "4", "--backend", "jnp", "--ledger", p,
                     "--device", "cpu"]) == 0
    evs = _read(p)
    summary = next(e for e in evs if e["event"] == "run_summary")
    assert summary["steps"] == 4 and "gcell_updates_per_sec" in summary
    metrics = next(e for e in evs if e["event"] == "metrics_summary")["metrics"]
    assert metrics["heat3d_step_latency_seconds"]["values"][""]["count"] == 1
    assert "heat3d_step_latency_seconds" in open(prom).read()


# ---- obs summary / tail / timeline: the same output from both packages ----------------


def _both(argv):
    """stdout of the port's and the JAX package's obs CLI on ``argv``."""
    from heat3d_tpu.obs.cli import main as jax_main
    from heat3d_tpu_torch.obs.cli import main as port_main

    outs = []
    for main in (port_main, jax_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
        outs.append((rc, buf.getvalue()))
    return outs


def _supervised_ledger(tmp_path):
    """A port ledger with most of the vocabulary: a supervised CLI run with
    an injected backend loss (fault, retry, heal, recovery, generations,
    checkpoints) and its step_cost."""
    from heat3d_tpu_torch.cli import main

    p = str(tmp_path / "sup.jsonl")
    env = {"HEAT3D_FAULTS": "backend-loss:step=4:down=1",
           "HEAT3D_HEAL_DEADLINE_S": "30"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["--grid", "8", "--steps", "8", "--checkpoint",
                         str(tmp_path / "gens"), "--checkpoint-every", "2",
                         "--supervise", "--device", "cpu", "--ledger", p]) == 0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return p


def test_summary_and_tail_print_the_same_as_jax(tmp_path):
    p = _port_cli_ledger(tmp_path, (2, 2, 2), 2)
    for argv in (["summary", p], ["tail", p, "-n", "50"]):
        (prc, pout), (jrc, jout) = _both(argv)
        assert prc == jrc == 0 and pout == jout and pout


def test_supervised_summary_prints_the_same_as_jax(tmp_path, monkeypatch):
    from heat3d_tpu_torch.utils import backendprobe

    # the heal probe child: the port's real one costs a torch start
    monkeypatch.setattr(backendprobe, "probe_platform", lambda timeout=None: "cpu")
    p = _supervised_ledger(tmp_path)
    assert jax_ledgerlint.check_file(p, taxonomy=True) == []
    names = [e["event"] for e in _read(p)]
    for want in ("supervised_start", "chunk", "fault_injected", "heal_wait", "recovery",
                 "generation_save", "ckpt_save", "ckpt_load", "supervised_end"):
        assert want in names, want
    (prc, pout), (jrc, jout) = _both(["summary", p])
    assert prc == jrc == 0 and pout == jout
    assert "recovery" in pout


def test_timeline_chrome_trace_same_as_jax(tmp_path):
    p = _port_cli_ledger(tmp_path, (1, 1, 1), 2)
    docs = []
    for tag in ("port", "jax"):
        out = str(tmp_path / f"{tag}.trace.json")
        docs.append(out)
    from heat3d_tpu.obs.perf.timeline import main as jax_tl
    from heat3d_tpu_torch.obs.perf.timeline import main as port_tl

    with contextlib.redirect_stdout(io.StringIO()) as pbuf:
        assert port_tl([p, "-o", docs[0], "--json"]) == 0
    with contextlib.redirect_stdout(io.StringIO()) as jbuf:
        assert jax_tl([p, "-o", docs[1], "--json"]) == 0
    assert json.load(open(docs[0])) == json.load(open(docs[1]))
    pj, jj = json.loads(pbuf.getvalue()), json.loads(jbuf.getvalue())
    pj["out"] = jj["out"] = None
    assert pj == jj


def test_init_state_span_fields(tmp_path):
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    p = str(tmp_path / "led.jsonl")
    obs.activate(p)
    solver = HeatSolver3D(SolverConfig(grid=GridConfig.cube(8)), device="cpu")
    solver.init_state("gaussian")
    solver.init_state(np.zeros((8, 8, 8), np.float32))
    obs.deactivate()
    spans = [e for e in _read(p) if e["event"] == "init_state"]
    assert [(s["init"], s["grid"]) for s in spans] == [("gaussian", [8, 8, 8]),
                                                      ("array", [8, 8, 8])]

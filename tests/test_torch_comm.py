"""The port's communication observatory on the CPU
(``heat3d_tpu_torch.obs.comm``), held to the JAX package's: the counterparts
of ``tests/test_comm.py`` — the per-link probe's byte model against the
schedule's traffic (and equal to the JAX ``probe_links``, monolithic and
partitioned), the phase folding of the per-link scopes, ``prefer='lower'``
decisions, clock alignment and per-link straggler attribution on merged
ledgers, the comm table, ``obs adjudicate`` on the committed CPU fixtures
(JSON equal to the JAX command's) and a synthetic contradiction, and the
standalone probe end to end on a CPU mesh of four shards (the ppermute and
dma transports); plus the one-link DMA launch tables and the env gate of
the probe hook ``bench_halo`` calls."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from heat3d_tpu import obs as jobs
from heat3d_tpu.core.config import BoundaryCondition as JBC
from heat3d_tpu.core.config import MeshConfig as JMeshConfig
from heat3d_tpu.obs.comm import adjudicate as jadjudicate
from heat3d_tpu.obs.perf.merge import merge_ledgers as jmerge_ledgers
from heat3d_tpu.obs.perf.timeline import detect_anomalies as jdetect
from heat3d_tpu.parallel.plan import build_plan
from heat3d_tpu_torch import obs
from heat3d_tpu_torch.obs.comm import adjudicate
from heat3d_tpu_torch.obs.comm.probe import probe_links
from heat3d_tpu_torch.obs.comm.report import comm_lines, comm_link_stats
from heat3d_tpu_torch.obs.perf.merge import merge_ledgers
from heat3d_tpu_torch.obs.perf.timeline import (
    PHASE_RE,
    detect_anomalies,
    format_anomaly,
    normalize_phase,
)
from heat3d_tpu_torch.parallel.plan import Schedule
from heat3d_tpu_torch.tune.decide import decide

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PLAN_AB = os.path.join(REPO, "plan_ab_cpu8.jsonl")
HALO_CPU8 = os.path.join(REPO, "halo_cpu8.jsonl")


@pytest.fixture(autouse=True)
def _isolated_obs(tmp_path, monkeypatch):
    monkeypatch.delenv("HEAT3D_LEDGER", raising=False)
    monkeypatch.delenv("HEAT3D_COMM_PROBE", raising=False)
    monkeypatch.delenv("HEAT3D_PLAN_PART_MIN_BYTES", raising=False)
    monkeypatch.setenv("HEAT3D_TUNE_CACHE", str(tmp_path / "tune.json"))
    obs.deactivate()
    jobs.deactivate()
    yield
    obs.deactivate()
    jobs.deactivate()


def _read(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


# ---- probe byte model (pure python, no devices) ----------------------------

_LINK_KEYS = ("axis", "axis_name", "direction", "sub_block", "sub_shape",
              "bytes_predicted", "scope")


@pytest.mark.parametrize(
    "mesh_shape,local_shape",
    [((4, 1, 1), (4, 16, 16)), ((2, 2, 2), (8, 8, 8))],
)
def test_probe_links_bytes_sum_to_plan_traffic(mesh_shape, local_shape):
    """Per-link bytes_predicted sum EXACTLY to the schedule's
    bytes_per_device, one lo and one hi link per sharded axis."""
    sched = Schedule(mesh_shape, 1)
    links = probe_links(sched, local_shape, itemsize=4)
    traffic = sched.traffic(local_shape, itemsize=4)
    assert links
    assert sum(ln["bytes_predicted"] for ln in links) == traffic["bytes_per_device"]
    sharded = sum(1 for s in mesh_shape if s > 1)
    assert len(links) == 2 * sharded
    assert all(ln["sub_block"] is None for ln in links)
    assert {ln["direction"] for ln in links} == {"lo", "hi"}
    for ln in links:
        assert ln["scope"] == f"halo.{ln['axis_name']}.{ln['direction']}"


def test_probe_links_partitioned_subblocks():
    """A floor of 0 forces genuine sub-blocks: each direction splits into
    .p0/.p1 whose bytes still sum to the monolithic face."""
    mono = Schedule((4, 1, 1), 1)
    part = Schedule((4, 1, 1), 1, mode="partitioned", min_part_bytes=0)
    links_m = probe_links(mono, (4, 16, 16), itemsize=4)
    links_p = probe_links(part, (4, 16, 16), itemsize=4)
    assert len(links_p) == 2 * len(links_m)
    assert sorted({ln["sub_block"] for ln in links_p}) == [0, 1]
    assert {ln["scope"] for ln in links_p} == {
        "halo.x.lo.p0", "halo.x.lo.p1", "halo.x.hi.p0", "halo.x.hi.p1"}
    assert sum(ln["bytes_predicted"] for ln in links_p) == sum(
        ln["bytes_predicted"] for ln in links_m)


@pytest.mark.parametrize("mode,floor", [("monolithic", 1 << 20), ("partitioned", 0),
                                        ("partitioned", 700)])
@pytest.mark.parametrize("order", ["axis", "pairwise"])
@pytest.mark.parametrize("mesh_shape,local_shape", [((4, 1, 1), (4, 16, 16)),
                                                    ((2, 2, 2), (8, 8, 8)),
                                                    ((1, 3, 2), (5, 6, 7))])
def test_probe_links_equal_jax(mesh_shape, local_shape, mode, floor, order):
    """The same links with the same bytes, shapes and scopes as the JAX
    ``probe_links`` over the JAX plan of the same mesh and local shape."""
    from heat3d_tpu.obs.comm.probe import probe_links as jprobe_links

    plan = build_plan(JMeshConfig(shape=mesh_shape), JBC.DIRICHLET, mode=mode,
                      min_part_bytes=floor, halo_order=order)
    ref = jprobe_links(plan, local_shape, itemsize=4)
    mine = probe_links(Schedule(mesh_shape, 1, mode, min_part_bytes=floor, halo_order=order),
                       local_shape, itemsize=4)
    assert [{k: ln[k] for k in _LINK_KEYS} for ln in mine] == [
        {k: ln[k] for k in _LINK_KEYS} for ln in ref]


# ---- phase folding ---------------------------------------------------------


def test_normalize_phase_folds_comm_scopes():
    for tok in ("halo", "halo.x.lo", "halo.z.hi", "halo.y.lo.p1", "halo.x.dma"):
        assert normalize_phase(tok) == "halo_exchange"
    assert normalize_phase("interior") != "halo_exchange"
    m = PHASE_RE.findall("jit_step/heat3d.halo.x.lo.p0/ppermute")
    assert m and m[-1] == "heat3d.halo.x.lo.p0"


# ---- decide extension ------------------------------------------------------


def test_decide_prefer_lower():
    rows = [
        {"bench": "halo", "halo_plan": "monolithic", "p50_us": 200.0},
        {"bench": "halo", "halo_plan": "partitioned", "p50_us": 100.0},
    ]
    entries = [({"halo_plan": r["halo_plan"]}, r) for r in rows]
    d = decide(entries, metric=lambda r: r.get("p50_us"), prefer="lower")
    assert len(d) == 1 and d[0]["winner"] == "partitioned"
    assert d[0]["speedup_pct"] == pytest.approx(100.0)
    d2 = decide(entries, metric=lambda r: r.get("p50_us"))
    assert d2[0]["winner"] == "monolithic"


# ---- clock alignment & stragglers ------------------------------------------


def _skewed_ledger(path, skew, step_s=0.4, steps=6):
    rows = []

    def ev(seq, event, kind, ts, **kw):
        rows.append(dict(ts=ts + skew, run_id="r1", proc=0, seq=seq, event=event,
                         kind=kind, **kw))

    ev(0, "ledger_open", "point", 100.0, schema=1)
    ev(1, "run_start", "point", 100.5, grid=[8, 8, 8])
    ev(2, "sync_overhead", "point", 100.6, sync_rtt_s=0.002)
    for i in range(steps):
        t0 = 101.0 + i * step_s
        ev(3 + i, "steps", "span", t0 + step_s, t0=t0, t1=t0 + step_s, dur_s=step_s,
           status="ok", steps=10)
    ev(3 + steps, "ledger_close", "point", 105.0, rc=0)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def test_unaligned_skew_reads_as_late_starter(tmp_path):
    a, b = str(tmp_path / "h0.jsonl"), str(tmp_path / "h1.jsonl")
    _skewed_ledger(a, 0.0)
    _skewed_ledger(b, 0.25)
    merged = merge_ledgers([a, b])
    assert merged["stats"].get("clock_align") is None
    anoms = detect_anomalies(merged["events"])
    late = [x for x in anoms if x["kind_"] == "start_straggler"]
    assert len(late) == 1 and late[0]["src"] == "h1.jsonl" and late[0]["status"] == "fail"
    assert late[0]["delta_pct"] == pytest.approx(62.5, abs=0.1)
    assert late[0]["offset_s"] == pytest.approx(0.25, abs=1e-6)
    assert "align" in format_anomaly(late[0])
    assert not [x for x in anoms if x["kind_"] == "host_straggler"]
    assert anoms == jdetect(jmerge_ledgers([a, b])["events"])


def test_align_removes_false_straggler(tmp_path):
    a, b = str(tmp_path / "h0.jsonl"), str(tmp_path / "h1.jsonl")
    _skewed_ledger(a, 0.0)
    _skewed_ledger(b, 0.25)
    merged = merge_ledgers([a, b], align=True)
    ca = merged["stats"]["clock_align"]
    assert ca["applied"] is True and ca["anchor_event"] == "run_start"
    assert ca["offsets_s"]["h1.jsonl"] == pytest.approx(0.25, abs=1e-6)
    assert ca["ci_s"] == pytest.approx(0.002, abs=1e-6)
    anoms = detect_anomalies(merged["events"])
    assert not [x for x in anoms if x["kind_"] in ("start_straggler", "host_straggler")]
    skewed = [e for e in merged["events"] if e.get("src") == "h1.jsonl"]
    assert all(e["ts_raw"] - e["ts"] == pytest.approx(0.25, abs=1e-9) for e in skewed)


def _probe_event(src, axis, direction, t_s, sub_block=None):
    return {"ts": 100.0, "run_id": "r1", "proc": 0, "seq": 0, "src": src,
            "event": "comm_probe", "kind": "point", "axis_name": axis,
            "direction": direction, "sub_block": sub_block, "t_s": t_s,
            "bytes_predicted": 1024}


def test_link_straggler_names_the_slow_link():
    events = []
    for src, slow in (("h0.jsonl", 1.0), ("h1.jsonl", 3.0)):
        for _ in range(4):
            events.append(_probe_event(src, "x", "lo", 100e-6))
            events.append(_probe_event(src, "x", "hi", 100e-6))
            events.append(_probe_event(src, "y", "hi", slow * 100e-6))
    links = [x for x in detect_anomalies(events) if x["kind_"] == "link_straggler"]
    assert len(links) == 1
    a = links[0]
    assert (a["src"], a["axis"], a["direction"]) == ("h1.jsonl", "y", "hi")
    assert a["status"] == "fail" and a["delta_pct"] == pytest.approx(200.0, abs=0.5)
    assert "slow link y.hi" in format_anomaly(a)


def test_comm_link_stats_folds_subblocks_and_flags_worst():
    events = [_probe_event("", "x", "lo", 100e-6, sub_block=0),
              _probe_event("", "x", "lo", 110e-6, sub_block=1),
              _probe_event("", "x", "hi", 400e-6)]
    stats = comm_link_stats(events)
    assert [(s["axis"], s["direction"]) for s in stats] == [("x", "hi"), ("x", "lo")]
    by_dir = {s["direction"]: s for s in stats}
    assert by_dir["lo"]["n"] == 2 and by_dir["lo"]["bytes"] == 2048
    assert by_dir["hi"]["worst"] is True and not by_dir["lo"]["worst"]
    lines = comm_lines(events)
    assert any("comm links (probe)" in ln for ln in lines)
    assert any("x.hi" in ln and "<- worst" in ln for ln in lines)
    assert comm_lines([]) == []


# ---- A/B adjudication ------------------------------------------------------


def test_adjudicate_committed_plan_ab_fixture(capsys):
    rc = adjudicate.main([PLAN_AB, "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["verdict"] == "pass" and out["rc"] == 0
    stages = {s["stage"]: s for s in out["stages"]}
    hp = stages["halo_plan"]
    assert hp["verdict"] == "pass" and hp["pairs"] == 4 and not hp["conflicts"]
    winners = {(w["context"]["mesh"], w["context"]["note"]): w["winner"]
               for w in hp["winners"]}
    assert winners[("8x1x1", "default-floor")] == "partitioned"
    assert winners[("8x1x1", "floor0-forced-subblocks")] == "monolithic"
    assert stages["halo_order"]["verdict"] == "no-data"
    assert stages["slab_width"]["verdict"] == "no-data"


def test_adjudicate_halo_fixture_all_no_data(capsys):
    rc = adjudicate.main([HALO_CPU8, "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["verdict"] == "no-data"
    assert all(s["verdict"] == "no-data" for s in out["stages"])


@pytest.mark.parametrize("fixture", [PLAN_AB, HALO_CPU8], ids=["plan_ab", "halo"])
@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_adjudicate_equals_the_jax_command(fixture, as_json):
    """The committed fixtures give the JAX command's output, byte for byte
    (the JSON verdict and the text report)."""
    args = [fixture] + (["--json"] if as_json else [])
    outs = []
    for main in (adjudicate.main, jadjudicate.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(list(args))
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]
    if as_json:
        assert json.loads(outs[0][1]) == json.loads(outs[1][1])


def test_adjudicate_contradiction_fails():
    ctx = {"bench": "halo", "grid": [64, 64, 64], "mesh": [8, 1, 1], "dtype": "float32",
           "platform": "cpu", "halo_order": "axis"}
    rows = [dict(ctx, halo_plan="monolithic", p50_us=100.0),
            dict(ctx, halo_plan="partitioned", p50_us=50.0),
            dict(ctx, halo_plan="monolithic", p50_us=40.0),
            dict(ctx, halo_plan="partitioned", p50_us=120.0)]
    verdict = adjudicate.adjudicate_rows(rows)
    assert verdict["verdict"] == "fail" and verdict["rc"] == 1
    hp = [s for s in verdict["stages"] if s["stage"] == "halo_plan"][0]
    assert hp["verdict"] == "fail" and hp["conflicts"]
    assert {"monolithic", "partitioned"} == set(hp["conflicts"][0]["winners"])
    assert verdict == jadjudicate.adjudicate_rows(rows)


def test_adjudicate_unreadable_input_rc2(tmp_path):
    assert adjudicate.main([str(tmp_path / "nope.jsonl")]) == 2


def test_adjudicate_emits_verdict_event(tmp_path):
    led = str(tmp_path / "led.jsonl")
    obs.activate(led, meta={"entry": "test"})
    rc = adjudicate.main([PLAN_AB, "--json"])
    obs.deactivate(rc=rc)
    vs = [e for e in _read(led) if e.get("event") == "adjudicate_verdict"]
    assert len(vs) == 1
    assert vs[0]["verdict"] == "pass" and vs[0]["rc"] == 0
    assert vs[0]["stages"]["halo_plan"] == "pass"


def test_obs_cli_dispatches_adjudicate(capsys):
    from heat3d_tpu_torch.obs.cli import main as obs_main

    assert obs_main(["adjudicate", PLAN_AB]) == 0
    out = capsys.readouterr().out
    assert "stage halo_plan" in out and "verdict: pass (rc 0)" in out


def test_adjudicate_reads_port_bench_rows(tmp_path):
    """Port throughput rows mirrored into a ledger (``bench_row``) pair on
    the slab-width stage like the JAX rows do."""
    import torch

    from heat3d_tpu_torch.bench import harness
    from heat3d_tpu_torch.core.config import GridConfig, SolverConfig

    led = str(tmp_path / "led.jsonl")
    obs.activate(led)
    for tb, secs in ((1, 0.2), (2, 0.1)):
        cfg = SolverConfig(grid=GridConfig.cube(16), time_blocking=tb)
        row = harness.throughput_row(cfg, steps=10, steps_requested=10, times=[secs],
                                     devices=[torch.device("cpu")], shards=1,
                                     sync_rtt_s=0.0, kernel_launches={})
        harness._ledger_bench_row(row)
    obs.deactivate()
    verdict = adjudicate.adjudicate_rows(adjudicate.load_rows(led))
    slab = [s for s in verdict["stages"] if s["stage"] == "slab_width"][0]
    assert slab["verdict"] == "pass" and slab["winners"][0]["winner"] == "2"


# ---- the probe itself ------------------------------------------------------


def test_comm_probe_env_gate_and_fail_soft(monkeypatch, capsys):
    from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig
    from heat3d_tpu_torch.obs.comm import probe

    cfg = SolverConfig(grid=GridConfig.cube(8), mesh=MeshConfig(shape=(2, 1, 1)))
    assert not probe.comm_probe_enabled() and probe.maybe_probe(cfg, device="cpu") == []
    monkeypatch.setenv("HEAT3D_COMM_PROBE", "1")
    monkeypatch.setenv("HEAT3D_COMM_PROBE_ITERS", "bogus")
    assert probe.probe_iters() == probe.DEFAULT_ITERS
    monkeypatch.setenv("HEAT3D_COMM_PROBE_ITERS", "1")
    rows = probe.maybe_probe(cfg, device="cpu")
    assert [r["scope"] for r in rows] == ["halo.x.lo", "halo.x.hi"]
    assert all(r["platform"] == "cpu" and r["senders"] == 1 for r in rows)

    def boom(*a, **k):
        raise RuntimeError("probe broke")

    monkeypatch.setattr(probe, "probe_plan", boom)
    assert probe.maybe_probe(cfg, device="cpu") == []
    assert "comm probe failed" in capsys.readouterr().err


def test_probe_copies_the_link_it_names():
    """Each link's move lands its sender's face sub-block in the
    receiver's ghost slab of that side: the plain exchange's copy, one
    link at a time (the partitioned sub-blocks together make the face)."""
    import torch

    from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig
    from heat3d_tpu_torch.obs.comm import probe
    from heat3d_tpu_torch.parallel.halo import padded_shape, push_axis_slabs
    from heat3d_tpu_torch.parallel.topology import build_shard_mesh

    cfg = SolverConfig(grid=GridConfig(shape=(8, 6, 10)), mesh=MeshConfig(shape=(2, 2, 1)))
    mesh = build_shard_mesh(cfg, "cpu")
    sched = Schedule(cfg.mesh.shape, 1, "partitioned", min_part_bytes=0)
    links = probe.probe_links(sched, cfg.local_shape, 4)
    gen = torch.Generator().manual_seed(0)
    base = [torch.rand(padded_shape(cfg.local_shape, 1), generator=gen) for _ in mesh.shards]
    got = [p.clone() for p in base]
    for link in links:
        trip, senders = probe._link_trip(cfg, mesh, got, link, 1, False, None)
        assert senders == 2
        trip()
    want = [p.clone() for p in base]
    for axis in (0, 1):
        for s in mesh.shards:
            push_axis_slabs(want, mesh, s, axis, 1, False, 0.0)
    # the probe moves links between shards only: compare the ghost slabs
    # a neighbour fills (domain faces keep their values in the probe)
    for s, g, w in zip(mesh.shards, got, want):
        for axis in (0, 1):
            n = cfg.local_shape[axis]
            for side, nb in ((0, mesh.neighbor(s, axis, -1, False)),
                             (1, mesh.neighbor(s, axis, +1, False))):
                if nb is None:
                    continue
                idx = [slice(1, 1 + m) for m in cfg.local_shape]
                idx[axis] = slice(0, 1) if side == 0 else slice(n + 1, n + 2)
                assert torch.equal(g[tuple(idx)], w[tuple(idx)])


def test_dma_link_launches_split_the_axis_tables():
    """The one-link DMA tables: for each side, every shard's item of that
    side and only the waits on its flag words; both sides together are the
    axis's launch."""
    import torch

    from heat3d_tpu_torch.ops.halo_dma import DmaState, link_launches
    from heat3d_tpu_torch.parallel.halo import padded_shape
    from heat3d_tpu_torch.parallel.topology import ShardMesh

    mesh = ShardMesh((3, 2, 1), (4, 4, 4), [torch.device("cpu")] * 6)
    pads = [torch.zeros(padded_shape(mesh.local_shape, 1)) for _ in mesh.shards]
    state = DmaState(mesh, pads, 1, periodic=False)
    for axis in (0, 1):
        (full,) = state.launches[axis]
        lo, hi = (link_launches(state, pads, axis, side)[0] for side in (0, 1))
        assert [i.dst for i in lo.items] == [i.dst for i in full.items[1::2]]
        assert [i.dst for i in hi.items] == [i.dst for i in full.items[0::2]]
        flags = {w.flag for w in full.waits}
        assert {w.flag for w in lo.waits} | {w.flag for w in hi.waits} == flags
        assert not {w.flag for w in lo.waits} & {w.flag for w in hi.waits}
        assert lo.cells + hi.cells == full.cells and lo.args is None


def _cpu_env():
    env = dict(os.environ)
    for k in ("HEAT3D_LEDGER", "HEAT3D_COMM_PROBE", "HEAT3D_PLAN_PART_MIN_BYTES"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    env["HEAT3D_COMM_PROBE_ITERS"] = "2"
    return env


@pytest.mark.parametrize("halo", ["ppermute", "dma"])
def test_probe_on_cpu_mesh_end_to_end(tmp_path, halo):
    """The standalone probe over four CPU shards: both x links timed, the
    schedule's bytes joined to a positive time in the JSON rows and the
    comm_probe ledger events, which ``obs summary`` renders."""
    led = str(tmp_path / "probe.jsonl")
    proc = subprocess.run(
        [sys.executable, "-m", "heat3d_tpu_torch.obs.comm.probe", "--grid", "8", "--mesh",
         "4", "1", "1", "--halo", halo, "--device", "cpu", "--json", "--ledger", led],
        env=_cpu_env(), capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    assert {(r["axis_name"], r["direction"]) for r in rows} == {("x", "lo"), ("x", "hi")}
    for r in rows:
        # grid 8^3 on 4x1x1 -> local (2, 8, 8): one float32 face = 256 B
        assert r["bytes_predicted"] == 8 * 8 * 4
        assert r["t_s"] > 0 and r["gbps"] > 0 and r["senders"] == 3
        assert r["plan_mode"] == "monolithic" and r["halo"] == halo
        assert r["scope"] == f"halo.x.{r['direction']}"
    probes = [e for e in _read(led) if e.get("event") == "comm_probe"]
    assert {(e["axis_name"], e["direction"]) for e in probes} == {("x", "lo"), ("x", "hi")}
    assert all(e["bytes_predicted"] == 256 for e in probes)
    from heat3d_tpu_torch.obs.cli import main as obs_main

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert obs_main(["summary", led]) == 0
    assert "comm links (probe)" in buf.getvalue()

"""The port's resilience layer (heat3d_tpu_torch.resilience,
utils.backendprobe, the supervised CLI) on the CPU: the counterpart of
every test of tests/test_resilience.py and tests/test_elastic.py that is
not about the ledger, provenance or serving, driven by the same
deterministic fault injection.

Results are held bitwise: a run that loses its backend, hangs, is killed or
re-plans onto survivors finishes equal to a clean supervised run, which
splits its steps into the same chunks (the supervisor's chunks end at
checkpoint points; the last is a residual step). The elastic runs step
part of the run on another mesh: the port's sharded solve equals the
(1,1,1) solve bitwise, so they are held bitwise too. Heal probes are
injected (``probe=``) everywhere but in the test of the real probe child,
which runs torch in a subprocess: here it finds ``"cpu"``, and a run that
started on the GPU (``want_platform="cuda"``) never counts it as healed.
"""

import dataclasses
import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat3d_tpu_torch.core import config
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.resilience import elastic
from heat3d_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedBackendLoss,
    _parse_spec,
    corrupt_one_shard,
)
from heat3d_tpu_torch.resilience.retry import RetryPolicy
from heat3d_tpu_torch.resilience.supervisor import load_latest_generation, run_supervised
from heat3d_tpu_torch.resilience.sweepstate import SweepState, row_key
from heat3d_tpu_torch.utils import backendprobe
from heat3d_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The supervisor's test-speed heal policy: milliseconds, not minutes.
FAST_HEAL = RetryPolicy(base_delay_s=0.01, multiplier=1.5, max_delay_s=0.05, deadline_s=5.0)


def _cfg(grid=8, mesh=(1, 1, 1), backend="jnp", **kw):
    return config.SolverConfig(grid=config.GridConfig.cube(grid),
                               mesh=config.MeshConfig(shape=mesh), backend=backend, **kw)


def tiny_solver(cfg=None):
    return HeatSolver3D(cfg or _cfg(), device="cpu")


def _field(res) -> np.ndarray:
    return res.solver.gather(res.u)


def _supervise(solver, steps, root, every, faults=None, **kw):
    kw.setdefault("heal_policy", FAST_HEAL)
    kw.setdefault("probe", lambda: "cpu")
    return solver.run_supervised(steps, str(root), checkpoint_every=every,
                                 faults=faults or FaultPlan(), **kw)


# ---- RetryPolicy -------------------------------------------------------------


class FakeClock:
    """Deterministic clock + sleep pair: sleep advances the clock."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def test_retry_backoff_schedule_and_validation():
    p = RetryPolicy(max_attempts=9, base_delay_s=2.0, multiplier=2.0, max_delay_s=9.0)
    d = p.delays()
    assert [next(d) for _ in range(5)] == [2.0, 4.0, 8.0, 9.0, 9.0]
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=3, multiplier=0.5)
    with pytest.raises(ValueError):
        RetryPolicy()  # unbounded: no attempts cap AND no deadline


def test_retry_deadline_budget_clamps_last_sleep():
    fc = FakeClock()
    p = RetryPolicy(base_delay_s=4.0, multiplier=2.0, max_delay_s=6.0, deadline_s=10.0)
    calls = []
    out = p.run(lambda: calls.append(1) and None, clock=fc.clock, sleep=fc.sleep)
    assert not out.ok and out.stop_reason == "deadline"
    assert fc.sleeps == [4.0, 6.0]
    assert len(out.attempts) == 3
    assert [a.error for a in out.attempts] == [None, None, None]


def test_retry_first_attempt_always_runs_at_zero_deadline():
    fc = FakeClock()
    p = RetryPolicy(base_delay_s=1.0, deadline_s=0.0)
    n = []
    out = p.run(lambda: n.append(1), success=lambda v: False, clock=fc.clock, sleep=fc.sleep)
    assert len(n) == 1 and out.stop_reason == "deadline"


def test_retry_attempts_cap_success_and_records():
    fc = FakeClock()
    seq = iter([None, None, "cuda"])
    p = RetryPolicy(max_attempts=8, base_delay_s=1.0, multiplier=1.0, max_delay_s=1.0)
    seen = []
    out = p.run(lambda: next(seq), on_attempt=seen.append, clock=fc.clock, sleep=fc.sleep)
    assert out.ok and out.value == "cuda" and out.stop_reason == "success"
    assert len(out.attempts) == 3 and out.attempts[-1].ok
    assert len(seen) == 3
    assert out.to_record()["attempts"] == 3
    exhausted = p.run(lambda: None, clock=fc.clock, sleep=fc.sleep)
    assert not exhausted.ok and exhausted.stop_reason == "attempts"
    assert len(exhausted.attempts) == 8


def test_retry_exception_counts_as_failed_attempt():
    fc = FakeClock()
    p = RetryPolicy(max_attempts=2, base_delay_s=0.0)

    def boom():
        raise OSError("probe spawn failed")

    out = p.run(boom, clock=fc.clock, sleep=fc.sleep)
    assert not out.ok
    assert out.attempts[0].error.startswith("OSError")
    assert out.to_record()["errors"]


def test_retry_jitter_bounded_and_deterministic():
    p = RetryPolicy(max_attempts=6, base_delay_s=10.0, multiplier=1.0, max_delay_s=10.0,
                    jitter_frac=0.2)
    runs = []
    for _ in range(2):
        fc = FakeClock()
        p.run(lambda: None, clock=fc.clock, sleep=fc.sleep, rng=random.Random(7))
        runs.append(fc.sleeps)
    assert runs[0] == runs[1]
    assert all(8.0 <= s <= 10.0 for s in runs[0])
    assert len(set(runs[0])) > 1


def test_retry_proceed_gate_gives_up():
    fc = FakeClock()
    p = RetryPolicy(max_attempts=10, base_delay_s=1.0)
    out = p.run(lambda: None, proceed=lambda: False, clock=fc.clock, sleep=fc.sleep)
    assert not out.ok and out.stop_reason == "gave_up"
    assert len(out.attempts) == 1


def test_retry_cli_prints_policy_delay(capsys):
    from heat3d_tpu_torch.resilience import retry

    assert retry._main(["--attempt", "2", "--base", "10", "--cap", "300", "--jitter", "0"]) == 0
    assert float(capsys.readouterr().out) == 15.0  # 10 * 1.5^1


def test_wait_for_backend_routes_through_policy(monkeypatch):
    seq = iter([None, "cuda", "cuda"])
    monkeypatch.setattr(backendprobe, "probe_platform", lambda: next(seq))
    assert backendprobe.wait_for_backend(5.0, 0.01) == "cuda"
    # the wanted device type never appears -> bounded None, not a hang
    monkeypatch.setattr(backendprobe, "probe_platform", lambda: "cpu")
    assert backendprobe.wait_for_backend(0.05, 0.01, want="cuda") is None
    assert backendprobe.wait_for_backend(0.05, 0.01, want=None) == "cpu"


# ---- FaultPlan ---------------------------------------------------------------


def test_fault_spec_parsing_and_errors():
    faults = _parse_spec("backend-loss:step=8:down=2,sigterm:row=3")
    assert [f.kind for f in faults] == ["backend-loss", "sigterm"]
    assert faults[0].params == {"step": 8, "down": 2}
    for bad in ("no-such-fault:step=1", "backend-loss:step=oops", "backend-loss:rows=1"):
        with pytest.raises(ValueError):
            _parse_spec(bad)


def test_fault_one_shot_firing_and_state_dir(tmp_path):
    state = str(tmp_path / "fstate")
    plan = FaultPlan.from_env({"HEAT3D_FAULTS": "backend-loss:step=4",
                               "HEAT3D_FAULT_STATE": state})
    plan.on_step(2)
    with pytest.raises(InjectedBackendLoss):
        plan.on_step(4)
    plan.on_step(4)  # one-shot: no refire
    # a NEW plan (process restart) sees the marker and stays quiet
    FaultPlan(_parse_spec("backend-loss:step=4"), state_dir=state).on_step(4)
    assert plan.probe_override() == "down"
    assert plan.probe_override() is None


def test_partial_device_loss_spec_parsing_and_validation():
    (f,) = _parse_spec("partial-device-loss:step=4:keep=2:down=1:restore=3")
    assert f.params == {"step": 4, "keep": 2, "down": 1, "restore": 3}
    (f,) = _parse_spec("partial-device-loss:batch=1:keep=1")
    assert f.params == {"batch": 1, "keep": 1}
    with pytest.raises(ValueError, match="keep"):
        _parse_spec("partial-device-loss:step=4")
    with pytest.raises(ValueError, match="exactly one"):
        _parse_spec("partial-device-loss:step=4:batch=1:keep=2")
    with pytest.raises(ValueError, match="exactly one"):
        _parse_spec("partial-device-loss:keep=2")


def test_partial_device_loss_fires_and_overrides_device_probe():
    plan = FaultPlan(_parse_spec("partial-device-loss:step=4:keep=2"))
    assert plan.device_override() is None
    plan.on_step(2)
    with pytest.raises(InjectedBackendLoss, match="2 device"):
        plan.on_step(4)
    plan.on_step(4)
    assert plan.probe_override() is None  # a partial loss is not an outage
    assert plan.device_override() == 2
    assert plan.device_override() == 2


def test_partial_device_loss_restore_decays():
    plan = FaultPlan(_parse_spec("partial-device-loss:step=1:keep=3:restore=2"))
    with pytest.raises(InjectedBackendLoss):
        plan.on_step(1)
    assert [plan.device_override() for _ in range(3)] == [3, 3, None]


def test_serve_batch_hook_fires_on_batch_index():
    plan = FaultPlan(_parse_spec("partial-device-loss:batch=1:keep=1"))
    plan.on_serve_batch(0)
    with pytest.raises(InjectedBackendLoss):
        plan.on_serve_batch(1)
    plan.on_serve_batch(2)
    assert plan.device_override() == 1


def test_corrupt_shard_flips_data_not_sidecar(tmp_path):
    s = tiny_solver()
    path = str(tmp_path / "ck")
    s.save_checkpoint(path, s.init_state("gaussian"), 1)
    sidecar = open(os.path.join(path, "shard_0_0_0.npy.crc32")).read()
    target = corrupt_one_shard(path)
    assert target.endswith("shard_0_0_0.npy")
    assert open(os.path.join(path, "shard_0_0_0.npy.crc32")).read() == sidecar
    assert np.load(target).shape == (8, 8, 8)


# ---- SweepState ---------------------------------------------------------------


def test_sweep_state_journal_and_torn_tail(tmp_path):
    path = str(tmp_path / "sweep.jsonl")
    s = SweepState(path)
    assert not s.is_done("a")
    s.mark_done("a", {"gcell": 1.0})
    s.mark_done("b")
    with open(path, "a") as f:
        f.write('{"key": "torn...')  # killed mid-append
    s2 = SweepState(path)
    assert s2.is_done("a") and s2.is_done("b")
    assert s2.record("a")["record"] == {"gcell": 1.0}
    assert s2.pending(["a", "b", "c"]) == ["c"]


def test_sweep_state_cli(tmp_path, capsys):
    from heat3d_tpu_torch.resilience import sweepstate

    path = str(tmp_path / "s.jsonl")
    assert sweepstate._main(["done", path, "k1"]) == 1
    assert sweepstate._main(["mark", path, "k1", '{"x": 1}']) == 0
    assert sweepstate._main(["done", path, "k1"]) == 0
    assert sweepstate._main(["list", path]) == 0
    assert capsys.readouterr().out.split() == ["k1"]
    assert sweepstate._main(["oops"]) == 2


ROW_KNOBS = [{}, {"time_blocking": 2}, {"halo": "dma"}, {"halo_order": "pairwise"},
             {"halo_plan": "partitioned"}, {"overlap": True, "mesh": (4, 1, 1)},
             {"precision": "bf16"}, {"stencil": "27pt"},
             {"equation": "aniso-diffusion", "eq_params": (("dx", 2.0),)}]


@pytest.mark.parametrize("knobs", ROW_KNOBS, ids=lambda k: ",".join(k) or "default")
def test_row_key_equals_jax_row_key(monkeypatch, knobs):
    """``row_key`` is the JAX package's string for the same config and
    environment, for both benches, so one journal serves both packages."""
    # imported here: the rest of the file runs on the card, without JAX
    from heat3d_tpu.core import config as rc
    from heat3d_tpu.resilience.sweepstate import row_key as ref_row_key

    monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")

    def build(m):
        kw = dict(knobs)
        mesh = kw.pop("mesh", (2, 1, 1))
        if kw.pop("precision", None):
            kw["precision"] = m.Precision.bf16()
        if "stencil" in kw:
            kw["stencil"] = m.StencilConfig(kind=kw["stencil"])
        return m.SolverConfig(grid=m.GridConfig.cube(8), mesh=m.MeshConfig(shape=mesh),
                              backend="jnp", **kw)

    for bench in ("throughput", "halo"):
        assert row_key(build(config), bench) == ref_row_key(build(rc), bench)


def test_row_key_covers_identity_knobs():
    cfg = _cfg()
    assert row_key(cfg) != row_key(dataclasses.replace(cfg, time_blocking=2))
    assert row_key(cfg) != row_key(cfg, "halo")
    assert row_key(cfg) == row_key(_cfg())


def _stub_bench_env(tmp_path, faults):
    """A subprocess environment whose bench runs stubbed measurements (the
    CPU has no card to time): each row carries a fresh random id, so a row
    re-emitted from the journal is told apart from a re-measured one."""
    env = dict(os.environ, PYTHONPATH=REPO, HEAT3D_FAULTS=faults,
               HEAT3D_FAULT_STATE=str(tmp_path / "fstate"))
    env.pop("HEAT3D_HEAL_MODE", None)
    return env


_STUB_BENCH = """
import runpy, sys, uuid
from heat3d_tpu_torch.bench import harness
harness.bench_throughput = lambda cfg, steps, repeats, device: {
    "bench": "throughput", "grid": list(cfg.grid.shape), "id": uuid.uuid4().hex}
harness.bench_halo = lambda cfg, iters, device: {
    "bench": "halo", "grid": list(cfg.grid.shape), "id": uuid.uuid4().hex}
sys.argv[0] = "heat3d_tpu_torch.bench"
runpy.run_module("heat3d_tpu_torch.bench", run_name="__main__", alter_sys=True)
"""


def test_sigterm_mid_sweep_leaves_resumable_state(tmp_path):
    """SIGTERM before row 1: the killed bench exits 3 with row 0 journaled;
    the rerun re-emits row 0 verbatim (not re-measured) and measures only
    the missing row."""
    state = str(tmp_path / "sweep.jsonl")
    args = [sys.executable, "-c", _STUB_BENCH, "--grid", "8", "--steps", "2",
            "--device", "cpu", "--bench", "all", "--sweep-state", state]
    env = _stub_bench_env(tmp_path, "sigterm:row=1")
    first = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300,
                           cwd=REPO)
    assert first.returncode == 3, first.stderr
    journal = SweepState(state)
    (key0,) = journal.keys()
    assert key0 == row_key(_cfg(backend="auto"), "throughput")
    landed = journal.record(key0)["record"]
    second = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300,
                            cwd=REPO)
    assert second.returncode == 0, second.stderr
    rows = [json.loads(ln) for ln in second.stdout.splitlines() if ln.startswith("{")]
    assert [r["bench"] for r in rows] == ["throughput", "halo"]
    assert rows[0] == landed
    assert len(SweepState(state).keys()) == 2


# ---- checkpoint checksums -----------------------------------------------------


def test_checkpoint_checksum_roundtrip_and_corruption(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    u = torch.arange(4 * 4 * 4, dtype=torch.float32).reshape(4, 4, 4)
    ckpt.save(d, u, 5)
    assert os.path.exists(os.path.join(d, "shard_0_0_0.npy.crc32"))
    mesh = tiny_solver(_cfg(grid=4)).mesh
    v, step, _ = ckpt.load(d, mesh)
    assert step == 5 and torch.equal(v, u)
    corrupt_one_shard(d)
    with pytest.raises(ckpt.ShardCorruptError):
        ckpt.load(d, mesh)
    # the forensics escape hatch still reads the damaged bytes
    monkeypatch.setenv("HEAT3D_CKPT_VERIFY", "0")
    v2, _, _ = ckpt.load(d, mesh)
    assert not torch.equal(v2, u)


def test_quarantine_moves_out_of_load_path(tmp_path):
    d = tmp_path / "gen-1"
    d.mkdir()
    (d / "x").write_text("data")
    q1 = ckpt.quarantine(str(d), reason="bad crc")
    assert q1.endswith(".quarantined") and os.path.exists(q1)
    assert open(os.path.join(q1, "QUARANTINED")).read() == "bad crc\n"
    assert not d.exists()
    d.mkdir()
    assert ckpt.quarantine(str(d)).endswith(".quarantined.1")


# ---- the supervisor ------------------------------------------------------------


SUPERVISED = [dict(), dict(mesh=(2, 2, 2), time_blocking=2, backend="auto"),
              dict(equation="wave", integrator="leapfrog")]


@pytest.mark.parametrize("kw", SUPERVISED, ids=["111", "222-tb2-kernels", "leapfrog"])
def test_supervised_backend_loss_resumes_bitwise(tmp_path, kw):
    """A run losing its backend at step 8 heals, resumes from gen-8 and
    finishes bit-for-bit equal to an uninterrupted supervised run; the
    generations are pruned to the newest two."""
    cfg = _cfg(**kw)
    clean = _supervise(tiny_solver(cfg), 12, tmp_path / "clean", 4)
    faulted = _supervise(tiny_solver(cfg), 12, tmp_path / "faulted", 4,
                         FaultPlan(_parse_spec("backend-loss:step=8:down=2")))
    assert faulted.steps_done == clean.steps_done == 12
    (rec,) = faulted.recoveries
    assert rec.kind == "backend-loss" and rec.resumed_from == 8
    assert rec.heal_attempts >= 3  # 2 injected down-probes + the heal
    np.testing.assert_array_equal(_field(faulted), _field(clean))
    if cfg.integrator == "leapfrog":
        np.testing.assert_array_equal(faulted.solver.gather(faulted.u[1]),
                                      clean.solver.gather(clean.u[1]))
        assert os.path.isdir(tmp_path / "faulted" / "gen-00000012" / "level-1")
    assert faulted.residual == clean.residual
    assert sorted(os.listdir(tmp_path / "faulted")) == ["gen-00000008", "gen-00000012"]
    assert faulted.solver is not None and faulted.solver.cfg == clean.solver.cfg


def test_supervised_rebuild_keeps_placement_and_taps(tmp_path):
    """The default recovery rebuilds the solver with the run's device and
    taps override; the resumed run equals the clean one."""
    taps = np.zeros((3, 3, 3))
    taps[1, 1, 1], taps[0, 1, 1], taps[2, 1, 1] = 0.5, 0.25, 0.25
    s = HeatSolver3D(_cfg(), device="cpu", taps=taps)
    res = _supervise(s, 6, tmp_path / "ck", 2,
                     FaultPlan(_parse_spec("backend-loss:step=2")))
    assert res.solver is not s
    assert res.solver.device == torch.device("cpu")
    np.testing.assert_array_equal(res.solver.taps, taps)
    clean = _supervise(HeatSolver3D(_cfg(), device="cpu", taps=taps), 6, tmp_path / "c", 2)
    np.testing.assert_array_equal(_field(res), _field(clean))


def test_supervised_hang_trips_watchdog_and_recovers(tmp_path):
    res = _supervise(tiny_solver(), 8, tmp_path / "ck", 2,
                     FaultPlan(_parse_spec("hang:step=4")), watchdog_s=0.05)
    assert res.steps_done == 8
    assert [r.kind for r in res.recoveries] == ["hang"]
    assert res.recoveries[0].resumed_from == 4
    clean = _supervise(tiny_solver(), 8, tmp_path / "c", 2)
    np.testing.assert_array_equal(_field(res), _field(clean))


def test_supervised_watchdog_overrun_probes_then_recovers(tmp_path):
    """A chunk that returns past its budget is probed; a probe that finds
    the backend gone makes it a hang recovery; one that finds it alive
    keeps the result."""
    answers = iter([None, "cpu"])
    res = _supervise(tiny_solver(), 4, tmp_path / "ck", 2, watchdog_s=0.0,
                     probe=lambda: next(answers, "cpu"))
    assert [r.kind for r in res.recoveries] == ["hang"]
    assert res.steps_done == 4


def test_supervised_corrupt_generation_quarantines_and_falls_back(tmp_path):
    root = tmp_path / "ck"
    _supervise(tiny_solver(), 8, root, 4)
    assert sorted(os.listdir(root)) == ["gen-00000004", "gen-00000008"]
    corrupt_one_shard(str(root / "gen-00000008"))
    resumed = _supervise(tiny_solver(), 12, root, 4)
    assert resumed.resumed_from == 4
    assert any(n.startswith("gen-00000008.quarantined") for n in os.listdir(root))
    clean = _supervise(tiny_solver(), 12, tmp_path / "clean", 4)
    np.testing.assert_array_equal(_field(resumed), _field(clean))


def test_supervised_corrupt_shard_fault_hook(tmp_path):
    """The corrupt-shard FAULT breaks the generation it fires on; the next
    load falls back a generation, and a loss after it recovers through the
    quarantine to the clean result."""
    root = str(tmp_path / "ck")
    _supervise(tiny_solver(), 8, root, 4, FaultPlan(_parse_spec("corrupt-shard:save=2")))
    loaded, quarantined = load_latest_generation(tiny_solver(), root)
    assert loaded is not None and loaded[1] == 4 and len(quarantined) == 1
    res = _supervise(tiny_solver(), 12, tmp_path / "ck2", 4,
                     FaultPlan(_parse_spec("corrupt-shard:save=2,backend-loss:step=8")))
    (rec,) = res.recoveries
    assert rec.resumed_from == 4 and len(rec.quarantined) == 1
    clean = _supervise(tiny_solver(), 12, tmp_path / "clean", 4)
    np.testing.assert_array_equal(_field(res), _field(clean))


def test_supervised_refuses_backward_target(tmp_path):
    root = tmp_path / "ck"
    _supervise(tiny_solver(), 6, root, 3)
    with pytest.raises(ValueError, match="past the target"):
        _supervise(tiny_solver(), 4, root, 2)


def test_supervised_refuses_to_restart_over_unloadable_generations(tmp_path):
    root = tmp_path / "ck"
    _supervise(tiny_solver(), 4, root, 2)
    with pytest.raises(ValueError, match="none is loadable"):
        _supervise(tiny_solver(_cfg(grid=12)), 8, root, 2)


def test_supervised_max_recoveries_reraises(tmp_path):
    plan = FaultPlan(_parse_spec("backend-loss:step=2,backend-loss:step=2:down=1"))
    with pytest.raises(InjectedBackendLoss):
        _supervise(tiny_solver(), 8, tmp_path / "ck", 2, plan, max_recoveries=1)


def test_supervised_sticky_error_reraises_after_max_recoveries(tmp_path):
    """A fault that every rebuilt solver hits again (a sticky CUDA error
    poisons the whole process's context) re-raises once max_recoveries is
    spent instead of spinning; the probe child says the card is down."""
    calls = []

    class Poisoned(HeatSolver3D):
        def run(self, u, num_steps):
            calls.append(num_steps)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    answers = []

    def probe():
        # down when a failure is classified, up for the heal wait after it
        answers.append(None if len(answers) % 2 == 0 else "cpu")
        return answers[-1]

    with pytest.raises(RuntimeError, match="illegal memory access"):
        _supervise(Poisoned(_cfg(), device="cpu"), 8, tmp_path / "ck", 4,
                   probe=probe, max_recoveries=2,
                   make_solver=lambda: Poisoned(_cfg(), device="cpu"))
    assert len(calls) == 3 and answers == [None, "cpu", None, "cpu", None]
    # a real error the probe explains as a live backend is a bug: raised at once
    calls.clear()
    with pytest.raises(RuntimeError):
        _supervise(Poisoned(_cfg(), device="cpu"), 8, tmp_path / "ck2", 4)
    assert len(calls) == 1


def test_supervised_resume_stitches_cross_mesh_checkpoint(tmp_path):
    """A generation saved as two x-blocks (another decomposition's layout)
    resumes onto (1,1,1) through the checkpoint's block stitching."""
    ref = _supervise(tiny_solver(), 8, tmp_path / "ref", 4)
    gen = tmp_path / "ck" / "gen-00000004"
    gen.mkdir(parents=True)
    src = np.load(tmp_path / "ref" / "gen-00000004" / "shard_0_0_0.npy")
    np.save(gen / "shard_0_0_0.npy", src[:4])
    np.save(gen / "shard_4_0_0.npy", src[4:])
    (gen / "manifest.json").write_text(json.dumps({
        "step": 4, "global_shape": [8, 8, 8], "dtype": "float32", "format": 1,
        "shards": [[0, 0, 0], [4, 0, 0]], "extra": {}}))
    resumed = _supervise(tiny_solver(), 8, tmp_path / "ck", 4)
    assert resumed.resumed_from == 4
    np.testing.assert_array_equal(_field(resumed), _field(ref))


def test_real_probe_child_never_heals_a_gpu_run(tmp_path):
    """The real probe child (torch in a subprocess) reports this host's
    device type, 'cpu'; a run that started on the GPU waits for 'cuda' and
    re-raises instead of healing onto the CPU."""
    assert backendprobe.probe_platform(timeout=120) == "cpu"
    assert backendprobe.probe_device_count(timeout=120) == 0
    with pytest.raises(InjectedBackendLoss):
        tiny_solver().run_supervised(
            4, str(tmp_path / "ck"), checkpoint_every=2, want_platform="cuda",
            heal_policy=RetryPolicy(max_attempts=1, base_delay_s=0.0),
            faults=FaultPlan(_parse_spec("backend-loss:step=2:down=0")))


def test_solver_supervises_with_its_own_device_type(tmp_path, monkeypatch):
    """Without an explicit want_platform the solver's run_supervised waits
    for its own device type: a CPU solver heals on 'cpu', never on another."""
    from heat3d_tpu_torch.resilience import supervisor

    seen = []
    monkeypatch.setattr(supervisor, "_default_probe", lambda want: seen.append(want) or want)
    res = tiny_solver().run_supervised(
        4, str(tmp_path / "ck"), checkpoint_every=2, heal_policy=FAST_HEAL,
        faults=FaultPlan(_parse_spec("backend-loss:step=2:down=0")))
    assert res.steps_done == 4 and seen == ["cpu"]


# ---- heal modes and elastic degradation ------------------------------------------


def test_resolve_heal_mode_env_and_validation(monkeypatch):
    monkeypatch.delenv(elastic.ENV_HEAL_MODE, raising=False)
    assert elastic.resolve_heal_mode() == "wait"
    assert elastic.resolve_heal_mode("elastic") == "elastic"
    monkeypatch.setenv(elastic.ENV_HEAL_MODE, "auto")
    assert elastic.resolve_heal_mode() == "auto"
    assert elastic.resolve_heal_mode("wait") == "wait"
    monkeypatch.setenv(elastic.ENV_HEAL_MODE, "sideways")
    with pytest.raises(ValueError, match="sideways"):
        elastic.resolve_heal_mode()


def test_heal_deadline_env_knob(monkeypatch):
    monkeypatch.delenv(elastic.ENV_HEAL_DEADLINE, raising=False)
    assert elastic.default_heal_policy().deadline_s == 1800.0
    monkeypatch.setenv(elastic.ENV_HEAL_DEADLINE, "120")
    assert elastic.default_heal_policy().deadline_s == 120.0
    for bad in ("soon", "-5"):
        monkeypatch.setenv(elastic.ENV_HEAL_DEADLINE, bad)
        assert elastic.default_heal_policy().deadline_s == 1800.0


def test_supervisor_rejects_elastic_without_factory(tmp_path):
    with pytest.raises(ValueError, match="make_solver_for"):
        run_supervised(tiny_solver(), 4, str(tmp_path / "ck"), checkpoint_every=2,
                       heal_mode="elastic")


def test_survivor_candidates_respect_restitch_contract():
    from heat3d_tpu_torch.tune.space import mesh_candidates, prune_reason, survivor_candidates

    assert mesh_candidates(4) == ((4, 1, 1), (2, 2, 1))
    assert mesh_candidates(8) == ((8, 1, 1), (2, 2, 2), (2, 4, 1))
    base = _cfg(mesh=(4, 1, 1))
    cands = survivor_candidates(base, 2, validate=False)
    assert cands and cands[0].mesh.shape == (2, 1, 1)
    assert all(c.padded_shape == base.padded_shape for c in cands)
    # validated by building the port's solver where the run's shards live
    built = []

    def on_cpu(cfg):
        built.append(cfg.mesh.shape)
        return HeatSolver3D(cfg, device="cpu")

    assert survivor_candidates(base, 2, make_solver=on_cpu) == cands
    assert built == [c.mesh.shape for c in cands]
    uneven = _cfg(mesh=(4, 1, 1), grid=8)
    uneven = dataclasses.replace(uneven, grid=config.GridConfig(shape=(10, 8, 8)))
    assert uneven.padded_shape == (12, 8, 8)
    assert survivor_candidates(uneven, 2, validate=False) == []
    assert elastic.survivor_config(uneven, 0) is None
    assert survivor_candidates(base, 0, validate=False) == []
    # the production gates: a route the candidate cannot run is pruned
    bad = dataclasses.replace(_cfg(), time_blocking=2, backend="auto")
    assert prune_reason(bad, on_cpu) is None
    assert "ValueError" in prune_reason(dataclasses.replace(bad, time_blocking=5,
                                                            mesh=config.MeshConfig(
                                                                shape=(8, 1, 1))), on_cpu)


def test_elastic_degrade_bitwise(tmp_path):
    """Losing 2 of 4 devices at step 8 re-factorizes (4,1,1) -> (2,1,1) on
    the run's device, resumes from gen-8 and finishes bitwise equal to a
    fresh (2,1,1) run resumed from the same checkpoint, and to the clean
    (4,1,1) run."""
    cfg = _cfg(mesh=(4, 1, 1))
    plan = FaultPlan(_parse_spec("partial-device-loss:step=8:keep=2"))
    root = tmp_path / "ck"
    res = _supervise(tiny_solver(cfg), 12, root, 4, plan, heal_mode="elastic")
    assert res.steps_done == 12 and res.degraded and res.mesh_shape == (2, 1, 1)
    assert res.refactors == 1 and res.solver.cfg.mesh.shape == (2, 1, 1)
    assert all(s.device == torch.device("cpu") for s in res.solver.mesh.shards)
    (rec,) = res.recoveries
    assert rec.kind == "backend-loss" and rec.elastic
    assert rec.mesh_shape == [2, 1, 1] and rec.resumed_from == 8 and rec.restitch_s >= 0
    assert res.to_record()["mesh_shape"] == [2, 1, 1]
    root2 = tmp_path / "ck2"
    root2.mkdir()
    shutil.copytree(root / "gen-00000008", root2 / "gen-00000008")
    small = dataclasses.replace(cfg, mesh=config.MeshConfig(shape=(2, 1, 1)))
    ref = _supervise(tiny_solver(small), 12, root2, 4)
    assert ref.resumed_from == 8
    np.testing.assert_array_equal(_field(res), _field(ref))
    assert res.residual == ref.residual
    clean = _supervise(tiny_solver(cfg), 12, tmp_path / "clean", 4)
    np.testing.assert_array_equal(_field(res), _field(clean))


def test_auto_mode_deadline_triggers_elastic(tmp_path):
    """auto: heal-wait first; the deadline flips the run to elastic. The
    same loss in wait mode re-raises."""
    deadline = RetryPolicy(base_delay_s=0.01, multiplier=1.0, max_delay_s=0.01,
                           deadline_s=0.05)

    def run(mode, root):
        return _supervise(tiny_solver(_cfg(mesh=(4, 1, 1))), 8, root, 4,
                          FaultPlan(_parse_spec("backend-loss:step=4:down=999")),
                          heal_policy=deadline, heal_mode=mode, device_probe=lambda: 2)

    with pytest.raises(InjectedBackendLoss):
        run("wait", tmp_path / "wait")
    res = run("auto", tmp_path / "auto")
    assert res.steps_done == 8 and res.degraded and res.mesh_shape == (2, 1, 1)
    assert res.recoveries[0].elastic


def test_elastic_replans_during_platform_outage(tmp_path):
    """elastic re-plans on the first survivor answer; auto waits the
    platform heal out to its deadline first."""
    deadline = RetryPolicy(base_delay_s=0.02, multiplier=1.0, max_delay_s=0.02,
                           deadline_s=0.2)

    def run(mode, root):
        return _supervise(tiny_solver(_cfg(mesh=(4, 1, 1))), 8, root, 4,
                          FaultPlan(_parse_spec("partial-device-loss:step=4:keep=2:down=999")),
                          heal_policy=deadline, heal_mode=mode)

    e = run("elastic", tmp_path / "e")
    assert e.steps_done == 8 and e.mesh_shape == (2, 1, 1)
    assert e.recoveries[0].heal_attempts == 1 and e.recoveries[0].heal_wait_s < 0.2
    a = run("auto", tmp_path / "a")
    assert a.steps_done == 8 and a.mesh_shape == (2, 1, 1)
    assert a.recoveries[0].heal_attempts > 1 and a.recoveries[0].heal_wait_s >= 0.2
    np.testing.assert_array_equal(_field(e), _field(a))


def test_reexpand_restores_full_mesh(tmp_path):
    """Opt-in re-expand: when capacity returns, the degraded run goes back
    onto the original mesh at the next checkpoint boundary and finishes
    equal to a clean run (bitwise: the sharded solves equal each other)."""
    cfg = _cfg(mesh=(4, 1, 1))
    plan = FaultPlan(_parse_spec("partial-device-loss:step=4:keep=2:restore=1"))
    res = _supervise(tiny_solver(cfg), 12, tmp_path / "ck", 2, plan,
                     heal_mode="elastic", reexpand=True, device_probe=lambda: 4)
    assert res.steps_done == 12 and not res.degraded
    assert res.mesh_shape == (4, 1, 1) and res.refactors == 2
    assert res.solver.cfg.mesh.shape == (4, 1, 1)
    clean = _supervise(tiny_solver(cfg), 12, tmp_path / "clean", 2)
    np.testing.assert_array_equal(_field(res), _field(clean))


def test_no_certified_survivor_mesh_resumes_on_current_mesh(tmp_path):
    """Survivors that no degraded config certifies (the padded shape would
    change) leave the healed run on its own mesh."""
    cfg = dataclasses.replace(_cfg(mesh=(4, 1, 1)), grid=config.GridConfig(shape=(10, 8, 8)))
    res = _supervise(tiny_solver(cfg), 6, tmp_path / "ck", 2,
                     FaultPlan(_parse_spec("partial-device-loss:step=2:keep=2")),
                     heal_mode="elastic")
    assert res.steps_done == 6 and not res.degraded and res.mesh_shape == (4, 1, 1)
    assert not res.recoveries[0].elastic


# ---- the command line ------------------------------------------------------------


def _port_cli(argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("HEAT3D_FAULTS", "HEAT3D_FAULT_STATE", "HEAT3D_HEAL_MODE"):
        env.pop(k, None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "heat3d_tpu_torch", *argv], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)


def test_cli_supervise_kill_and_resume_matches_clean(tmp_path):
    """--supervise killed at step 4 by an injected SIGTERM exits 3; the
    same command relaunched resumes and its final generation's shard BYTES
    equal a never-killed run's (both split the 8 steps at every 2nd)."""
    base = ["--grid", "8", "--steps", "8", "--checkpoint-every", "2", "--supervise",
            "--device", "cpu", "--time-blocking", "2"]
    clean = _port_cli([*base, "--checkpoint", str(tmp_path / "clean")])
    assert clean.returncode == 0, clean.stderr
    faults = {"HEAT3D_FAULTS": "sigterm:step=4", "HEAT3D_FAULT_STATE": str(tmp_path / "fs")}
    killed = _port_cli([*base, "--checkpoint", str(tmp_path / "kill")], faults)
    assert killed.returncode == 3, killed.stderr
    gens = sorted(os.listdir(tmp_path / "kill"))
    assert gens and gens[-1] < "gen-00000008"
    resumed = _port_cli([*base, "--checkpoint", str(tmp_path / "kill")], faults)
    assert resumed.returncode == 0, resumed.stderr
    summary = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert summary["supervised"]["steps_done"] == 8
    assert summary["supervised"]["start_step"] >= 4 and summary["steps"] <= 4
    for name in ("shard_0_0_0.npy", "shard_0_0_0.npy.crc32"):
        assert (tmp_path / "clean" / "gen-00000008" / name).read_bytes() == \
            (tmp_path / "kill" / "gen-00000008" / name).read_bytes()


def test_cli_supervise_argument_checks(tmp_path, capsys):
    from heat3d_tpu_torch import cli

    base = ["--grid", "8", "--steps", "4", "--device", "cpu", "--supervise"]
    assert cli.main(base) == 2
    assert "requires --checkpoint" in capsys.readouterr().err
    flat = str(tmp_path / "flat")
    assert cli.main(["--grid", "8", "--steps", "2", "--device", "cpu",
                     "--checkpoint", flat]) == 0
    capsys.readouterr()
    assert cli.main([*base, "--checkpoint", flat]) == 2
    assert "plain checkpoint" in capsys.readouterr().err
    assert cli.main([*base, "--checkpoint", str(tmp_path / "g"), "--tol", "1e-3"]) == 2
    assert "--tol" in capsys.readouterr().err
    assert cli.main([*base, "--checkpoint", str(tmp_path / "h"), "--residual-every", "2",
                     "--checkpoint-every", "2", "--golden-check"]) == 0
    out = capsys.readouterr()
    assert "--residual-every is not supported" in out.err
    summary = json.loads(out.out.strip().splitlines()[-1])
    assert summary["golden_pass"] and summary["supervised"]["checkpoints_written"] == 2
    os.environ["HEAT3D_HEAL_MODE"] = "sideways"
    try:
        assert cli.main([*base, "--checkpoint", str(tmp_path / "i")]) == 2
    finally:
        del os.environ["HEAT3D_HEAL_MODE"]
    assert "sideways" in capsys.readouterr().err


def test_cli_supervise_elastic_partial_loss(tmp_path, capsys):
    """--heal-mode elastic through the command line: the injected partial
    loss re-plans (2,2,2) onto 4 survivors on the run's device; the
    summary describes the mesh the run finished on."""
    from heat3d_tpu_torch import cli

    os.environ["HEAT3D_FAULTS"] = "partial-device-loss:step=2:keep=4"
    try:
        rc_ = cli.main(["--grid", "8", "--steps", "4", "--mesh", "2", "2", "2",
                        "--device", "cpu", "--supervise", "--checkpoint",
                        str(tmp_path / "ck"), "--checkpoint-every", "2",
                        "--heal-mode", "elastic", "--golden-check"])
    finally:
        del os.environ["HEAT3D_FAULTS"]
    assert rc_ == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["mesh"] == [4, 1, 1] and summary["golden_pass"]
    sup = summary["supervised"]
    assert sup["degraded"] and sup["mesh_shape"] == [4, 1, 1] and sup["refactors"] == 1


@pytest.mark.cuda
def test_checkpoint_from_shard_streams_equals_gather(tmp_path):
    """On the card: a (2,2,2) solve on cuda:0 (a stream per shard), saved
    right after its last launch, holds the gathered field; loaded back it
    steps on bitwise as the uninterrupted solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    cfg = config.SolverConfig(grid=config.GridConfig.cube(64),
                              mesh=config.MeshConfig(shape=(2, 2, 2)), time_blocking=2)
    s = HeatSolver3D(cfg, device="cuda:0")
    u = s.run(s.init_state("hot-cube"), 6)
    path = str(tmp_path / "ck")
    s.save_checkpoint(path, u, 6)
    want = s.gather(u)
    got, _, _ = ckpt.load(path, HeatSolver3D(
        dataclasses.replace(cfg, mesh=config.MeshConfig()), device="cpu").mesh)
    np.testing.assert_array_equal(got.numpy(), want)
    u2, step = s.load_checkpoint(path)
    assert step == 6
    a = s.gather(s.run(u2, 4))
    b = s.gather(s.run(u, 4))
    np.testing.assert_array_equal(a, b)


# ---- the ledger of the supervised run (the JAX obs calls, put back) ---------------


@pytest.fixture
def ledger(tmp_path, monkeypatch):
    """An active port ledger for the test; its events, read back."""
    from heat3d_tpu_torch import obs

    monkeypatch.delenv("HEAT3D_LEDGER", raising=False)
    path = str(tmp_path / "led.jsonl")
    obs.deactivate()
    obs.activate(path)

    def events():
        obs.deactivate()
        return [json.loads(line) for line in open(path) if line.strip()]

    yield events
    obs.deactivate()


def test_supervised_recovery_rerecords_step_cost(tmp_path, ledger):
    """A recovery that REBUILDS the solver (make_solver) re-emits the
    step_cost ledger event tagged post_heal; the reuse path does not."""
    from heat3d_tpu_torch import obs
    from heat3d_tpu_torch.obs.check import check_file

    res = run_supervised(tiny_solver(), 8, str(tmp_path / "ck"), checkpoint_every=4,
                         heal_policy=FAST_HEAL, probe=lambda: "cpu",
                         faults=FaultPlan(_parse_spec("backend-loss:step=4")),
                         make_solver=tiny_solver)
    assert res.steps_done == 8 and len(res.recoveries) == 1
    evs = ledger()
    (c,) = [e for e in evs if e.get("event") == "step_cost" and e.get("post_heal")]
    assert c["ok"] is True and c["step"] == 4 and c["cost_flops_per_step"] > 0
    from heat3d_tpu_torch.obs.perf.roofline import step_cost_fields

    # the jnp arm's exchange path: field and padded block, each written
    # and read once (2 * (8^3 + 10^3) * 4 bytes)
    assert c["platform"] == "cpu" and c["cost_bytes_per_step"] == 2 * (8 ** 3 + 10 ** 3) * 4
    assert c["cost_bytes_per_step"] == step_cost_fields(_cfg())["cost_bytes_per_step"]
    assert check_file(str(tmp_path / "led.jsonl"), taxonomy=True) == []
    led2 = str(tmp_path / "led2.jsonl")
    obs.activate(led2)
    run_supervised(tiny_solver(), 8, str(tmp_path / "ck2"), checkpoint_every=4,
                   heal_policy=FAST_HEAL, probe=lambda: "cpu",
                   faults=FaultPlan(_parse_spec("backend-loss:step=4")))
    obs.deactivate()
    evs2 = [json.loads(line) for line in open(led2) if line.strip()]
    assert not any(e.get("event") == "step_cost" and e.get("post_heal") for e in evs2)


def test_supervised_ledger_reconstructs_the_run(tmp_path, ledger):
    """The supervised run's ledger holds every chunk (the failed one with
    status error), the fault, the heal wait and its retry attempts, the
    generation transitions, the checkpoint spans and the recovery; the
    summary's step latency equals the run's own histogram."""
    from heat3d_tpu_torch import obs
    from heat3d_tpu_torch.obs.check import check_file
    from heat3d_tpu_torch.obs.cli import step_latencies
    from heat3d_tpu_torch.obs.metrics import percentile

    obs.REGISTRY.reset()
    res = _supervise(tiny_solver(), 12, tmp_path / "ck", 4,
                     FaultPlan(_parse_spec("backend-loss:step=8:down=2")))
    metrics = obs.REGISTRY.snapshot()
    evs = ledger()
    assert res.steps_done == 12 and len(res.recoveries) == 1
    assert check_file(str(tmp_path / "led.jsonl"), taxonomy=True) == []
    chunks = [e for e in evs if e["event"] == "chunk"]
    assert [c["status"] for c in chunks].count("error") == 1 and len(chunks) == 4
    fault = next(e for e in evs if e["event"] == "fault_injected")
    assert fault["kind_"] == "backend-loss" and fault["step"] == 8
    heal = next(e for e in evs if e["event"] == "heal_wait")
    assert heal["ok"] and heal["failure"] == "backend-loss" and heal["mode"] == "wait"
    assert len([e for e in evs if e["event"] == "retry_attempt"]) >= 3
    assert [g["step"] for g in evs if g["event"] == "generation_save"] == [4, 8, 12]
    recovery = next(e for e in evs if e["event"] == "recovery")
    assert recovery["resumed_from"] == 8 and recovery["kind_"] == "backend-loss"
    assert any(e["event"] == "generation_save" and e["step"] == 12 and e["generation"] == 8
               for e in evs)
    start = next(e for e in evs if e["event"] == "supervised_start")
    end = next(e for e in evs if e["event"] == "supervised_end")
    assert start["total_steps"] == 12 and end["steps_done"] == 12 and end["recoveries"] == 1
    lats = step_latencies(evs)
    own = metrics["heat3d_step_latency_seconds"]["values"][""]
    assert len(lats) == 3
    for q, key in ((50, "p50"), (95, "p95")):
        assert abs(percentile(lats, q) - own[key]) <= 0.2 * own[key]


def test_elastic_degrade_ledger(tmp_path, ledger):
    """The ledger of the elastic degrade: one elastic_refactor (4,1,1) ->
    (2,1,1) with its survivors and re-stitch seconds, one
    degraded_mode_enter, supervised_end degraded on (2,1,1), and the
    post-heal step_cost of the survivor mesh."""
    plan = FaultPlan(_parse_spec("partial-device-loss:step=8:keep=2"))
    res = _supervise(tiny_solver(_cfg(mesh=(4, 1, 1))), 12, tmp_path / "ck", 4, plan,
                     heal_mode="elastic")
    evs = ledger()
    assert res.degraded and res.mesh_shape == (2, 1, 1)
    (ref,) = [e for e in evs if e["event"] == "elastic_refactor"]
    assert ref["old_mesh"] == [4, 1, 1] and ref["new_mesh"] == [2, 1, 1]
    assert ref["survivors"] == 2 and ref["lost_devices"] == 2 and ref["restitch_s"] >= 0
    assert ref["direction"] == "degrade" and ref["step"] == 8 and ref["resumed_from"] == 8
    (enter,) = [e for e in evs if e["event"] == "degraded_mode_enter"]
    assert enter["mesh"] == [2, 1, 1] and enter["survivors"] == 2
    end = [e for e in evs if e["event"] == "supervised_end"][-1]
    assert end["degraded"] is True and end["mesh"] == [2, 1, 1] and end["refactors"] == 1
    from heat3d_tpu_torch.obs.perf.roofline import step_cost_fields

    (cost,) = [e for e in evs if e["event"] == "step_cost" and e.get("post_heal")]
    assert cost["ok"] and cost["cost_bytes_per_step"] == step_cost_fields(
        res.solver.cfg)["cost_bytes_per_step"]
    assert res.solver.cfg.mesh.shape == (2, 1, 1)


def test_reexpand_ledger(tmp_path, ledger):
    """Re-expand closes the degraded window: the refactors degrade then
    expand, one degraded_mode_exit with its seconds."""
    plan = FaultPlan(_parse_spec("partial-device-loss:step=4:keep=2:restore=1"))
    res = _supervise(tiny_solver(_cfg(mesh=(4, 1, 1))), 12, tmp_path / "ck", 2, plan,
                     heal_mode="elastic", reexpand=True, device_probe=lambda: 4)
    evs = ledger()
    assert not res.degraded and res.refactors == 2
    refs = [e for e in evs if e["event"] == "elastic_refactor"]
    assert [r["direction"] for r in refs] == ["degrade", "expand"]
    assert refs[1]["old_mesh"] == [2, 1, 1] and refs[1]["new_mesh"] == [4, 1, 1]
    (exit_,) = [e for e in evs if e["event"] == "degraded_mode_exit"]
    assert exit_["degraded_s"] >= 0 and exit_["mesh"] == [4, 1, 1]


def test_obs_summary_elastic_section():
    """The port's summary section is the JAX one, line for line."""
    from heat3d_tpu.obs.cli import elastic_lines as jax_lines
    from heat3d_tpu_torch.obs.cli import elastic_lines

    events = [
        {"event": "elastic_refactor", "direction": "degrade", "old_mesh": [4, 1, 1],
         "new_mesh": [2, 1, 1], "survivors": 2, "restitch_s": 0.8, "step": 8},
        {"event": "degraded_mode_enter", "step": 8, "mesh": [2, 1, 1]},
    ]
    lines = elastic_lines(events)
    assert lines == jax_lines(events) and len(lines) == 3
    assert "[4, 1, 1] -> [2, 1, 1]" in lines[0] and "still degraded" in lines[2]
    events.append({"event": "degraded_mode_exit", "step": 12, "mesh": [4, 1, 1],
                   "degraded_s": 3.5})
    lines = elastic_lines(events)
    assert lines == jax_lines(events) and len(lines) == 3 and "EXIT" in lines[2]
    assert elastic_lines([{"event": "run_start"}]) == []


def test_provenance_post_heal_and_weak_scaling_rules(tmp_path):
    """The JAX provenance lint's post-heal rules hold the port's rows: a
    port throughput row tagged post_heal passes with the survivor mesh's
    mesh_shape and fails without it; the weak-scaling rows' rules are the
    same for both packages' rows."""
    from heat3d_tpu.analysis.provenance import check_file
    from heat3d_tpu_torch.bench import harness

    cfg = _cfg(8, (2, 1, 1))
    row = harness.throughput_row(cfg, steps=4, steps_requested=4, times=[1e-3],
                                 devices=[torch.device("cpu")], shards=2, sync_rtt_s=1e-6,
                                 kernel_launches={})
    p2 = tmp_path / "thr.jsonl"
    p2.write_text("\n".join(json.dumps(r) for r in [
        row,
        {**row, "post_heal": True},                           # 2: no mesh
        {**row, "post_heal": True, "mesh_shape": [2, 1, 1]},  # 3: ok
    ]))
    assert [line for line, _ in check_file(str(p2))] == [2]
    ws_good = {"bench": "weak_scaling", "ts": row["ts"], "platform": "cpu",
               "mesh_shape": [2, 1, 1], "gcell_per_sec_per_chip": 0.5, "post_heal": False}
    ws_heal = {**ws_good, "post_heal": True, "recovery_s": 1.25}
    rows = [ws_good, ws_heal,
            {k: v for k, v in ws_good.items() if k != "post_heal"},
            {**ws_heal, "recovery_s": None},
            {k: v for k, v in ws_heal.items() if k != "mesh_shape"},
            {**ws_good, "gcell_per_sec_per_chip": None},
            {"bench": "weak_scaling", "platform": "cpu"}]
    p = tmp_path / "ws.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows))
    assert {line for line, _ in check_file(str(p))} == {3, 4, 5, 6, 7}

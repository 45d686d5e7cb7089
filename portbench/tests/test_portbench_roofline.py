"""The frozen yardstick: bounds, op counts, and the readers over a small
synthetic Chrome trace."""

import pytest

from portbench import cells, drive, roofline, timeline

BENCH = cells.load_benchmark()
CONFIG = dict(cells.config(BENCH, "heat7-fp32-2048x1024x1024"), grid=[1024, 1024, 1024])
MARCH = {"run": {"residual_every": 0}}
CONVERGE = {"run": {"residual_every": 1}}


def test_one_sweep_bound():
    # two updates at tb=2 are one 1024^3 sweep: the field read and written once
    assert roofline.stencil_bound_s(CONFIG, MARCH, 2) * 1e3 == pytest.approx(2.564, abs=5e-4)
    assert roofline.stencil_bound_s(CONFIG, CONVERGE, 1) * 1e3 == pytest.approx(2.564, abs=5e-4)
    assert roofline.residual_bound_s(CONFIG, 1) * 1e3 == pytest.approx(2.564, abs=5e-4)


@pytest.mark.parametrize("mehrstellen", ["", "1"])
def test_op_counts_frozen(monkeypatch, mehrstellen):
    """The counts are the chain's at the default factoring whatever the
    route knob says, and equal the program's ``chain_ops`` without it."""
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", mehrstellen)
    assert roofline.OPS_PER_CELL == {"7pt": 13, "27pt": 26}
    monkeypatch.delenv("HEAT3D_MEHRSTELLEN")
    from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps
    from heat3d_tpu_torch.ops.stencil_direct import chain_ops

    for kind, ops in roofline.OPS_PER_CELL.items():
        assert chain_ops(stencil_taps(STENCILS[kind], 1.0, 0.15, (1.0, 1.0, 1.0))) == ops


def _trace():
    """A 10 ms window: two stencil kernels of 3 ms in heat3d.stencil ranges,
    one residual kernel of 1 ms, 1 ms idle at each edge."""
    ev = []

    def x(cat, name, ts, dur, tid, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
                   "tid": tid, "args": args})

    x("user_annotation", timeline.WINDOW, 1000.0, 10000.0, 1)
    x("user_annotation", "heat3d.step", 1000.0, 5000.0, 1)
    x("user_annotation", "heat3d.stencil", 1010.0, 100.0, 1)
    x("cuda_runtime", "cudaLaunchKernel", 1020.0, 5.0, 1, correlation=1)
    x("user_annotation", "heat3d.stencil", 1200.0, 100.0, 1)
    x("cuda_runtime", "cudaLaunchKernel", 1210.0, 5.0, 1, correlation=2)
    x("user_annotation", "heat3d.residual", 1400.0, 100.0, 1)
    x("cuda_runtime", "cudaLaunchKernel", 1410.0, 5.0, 1, correlation=3)
    x("kernel", "void direct_kernel<float, 2>(...)", 2000.0, 3000.0, 7, correlation=1)
    x("kernel", "void direct_kernel<float, 2>(...)", 5000.0, 3000.0, 7, correlation=2)
    x("kernel", "reduce_kernel", 8000.0, 1000.0, 7, correlation=3)
    x("kernel", "outside", 20000.0, 1000.0, 7, correlation=4)
    return {"traceEvents": ev}


def test_activity_window_and_gaps():
    act = timeline.activity(_trace())
    assert act["window_s"] == pytest.approx(0.010)
    assert act["busy_s"] == pytest.approx(0.007)
    assert act["phases"]["heat3d.stencil"] == pytest.approx(0.006)
    assert act["phases"]["heat3d.residual"] == pytest.approx(0.001)
    assert [round(s, 6) for _, s in act["gaps"]] == [0.002, 0.001]


def test_readers_on_the_trace():
    act = timeline.activity(_trace())
    run = drive.Run(setup_s=1, solver_init_s=1, window_s=1, updates=4, chunks=1, launches=2,
                    memory_peak_bytes=0, window_peak_bytes=0, start=None, start_residual=None,
                    sample_chunk=1, sample_in=None, sample_out=None, sample_residual=None,
                    profiled_updates=2, activity=act)
    ctx = {"config": CONFIG, "mix": CONVERGE, "run": run,
           "gpus": 1, "grid": tuple(CONFIG["grid"])}
    idle = cells.reader("device_idle_pct")(ctx)
    assert idle == pytest.approx(30.0)
    stencil = cells.reader("stencil_roofline")(ctx)
    assert stencil == pytest.approx(100 * 2 * 2.5638e-3 / 6e-3, rel=1e-3)
    # 2.56 ms of residual work in 1 ms of device time: a count too high
    assert cells.reader("residual_roofline")(ctx) > 105
    assert cells.reader("kernel_launches_per_update")(ctx) == 0.5
    ctx["mix"] = MARCH
    assert cells.reader("residual_roofline")(ctx) is None
    run.activity = None
    assert cells.reader("stencil_roofline")(ctx) is None
    assert cells.reader("device_idle_pct")(ctx) is None

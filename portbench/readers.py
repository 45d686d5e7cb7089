"""The readers that the metric files of ``metrics/`` bind as ``read``: one
function for each quantity."""

import re

from portbench import roofline

STENCIL_KERNELS = re.compile(r"^(void )?(\(anonymous namespace\)::)?"
                             r"(direct|stream|fused)_\w*(kernel|generic)\b")


def gcell_updates_per_s_per_gpu(ctx):
    """Cells of the grid times the updates completed in the window, over
    the window's seconds on the host clock (it opens and closes on a
    synchronize), per GPU, in billions."""
    nx, ny, nz = ctx["grid"]
    run = ctx["run"]
    return nx * ny * nz * run.updates / run.window_s / ctx["gpus"] / 1e9


def peak_mem_gib(ctx):
    """``torch.cuda.max_memory_allocated()`` over the window, reset at its
    start, less the benchmark's own copies of the checked answers, in GiB."""
    run = ctx["run"]
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes > 0 else None


def setup_s(ctx):
    """Seconds from the harness's first line to the first timed update:
    imports, the CUDA context, the kernel library (built on a checkout's
    first run), the solver, the seeded field and the warm-up calls."""
    return ctx["run"].setup_s


def solver_init_s(ctx):
    """Host seconds of ``HeatSolver3D(...)``, the seeded initial field and
    the first call (whose first launch loads the kernel library), ended by
    a synchronize."""
    return ctx["run"].solver_init_s


def kernel_launches_per_update(ctx):
    """The program's kernel launches over the window
    (``heat3d_tpu_torch.ops.launch_counts()``, all wrappers) per update:
    0.5 on the two-update direct sweep, 1 where every update is its own
    launch."""
    run = ctx["run"]
    return run.launches / run.updates if run.updates else None


def device_idle_pct(ctx):
    """100 x (1 - the union of all device activity / the profiled window),
    the window bounded by the benchmark's range and not by the first and
    last kernel."""
    act = ctx["run"].activity
    if not act or act["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - act["busy_s"] / act["window_s"])


def _residuals(ctx) -> int:
    every = roofline.residual_every(ctx["mix"])
    return ctx["run"].profiled_updates // every if every > 0 else 0


def stencil_roofline(ctx):
    """The least time of the profiled window's stencil work (bytes and
    operations counted from the configuration and mix,
    ``portbench.roofline``) over the device time of the kernels launched
    inside ``heat3d.stencil`` ranges, in %. Where no such range holds a
    launch, the port's stencil kernels are taken by name."""
    run = ctx["run"]
    act = run.activity
    if not act or not run.profiled_updates:
        return None
    device_s = act["phases"].get("heat3d.stencil", 0.0)
    if device_s <= 0:
        device_s = sum(s for name, s in act["ops"].items() if STENCIL_KERNELS.match(name))
    if device_s <= 0:
        return None
    least = roofline.stencil_bound_s(ctx["config"], ctx["mix"], run.profiled_updates)
    return 100.0 * least / device_s


def residual_roofline(ctx):
    """The least time to read the new and the old field once for each
    residual of the profiled window over the device time inside
    ``heat3d.residual`` ranges, in %."""
    act = ctx["run"].activity
    residuals = _residuals(ctx)
    if not act or not residuals:
        return None
    device_s = act["phases"].get("heat3d.residual", 0.0)
    if device_s <= 0:
        return None
    return 100.0 * roofline.residual_bound_s(ctx["config"], residuals) / device_s

"""The port stands alone: heat3d_tpu_torch and chip_smoke.py import neither
JAX, the JAX package nor ``ml_dtypes`` (the GPU machine has none), and the
port never drops to the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# the package's sources; its build directory holds no source of its own
PORT_FILES = sorted(
    p for p in (REPO / "heat3d_tpu_torch").rglob("*.py") if "_build" not in p.parts
) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "heat3d_tpu", "ml_dtypes")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_the_package():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("ops/stencil_direct.py", "ops/stencil_stream.py", "ops/halo_dma.py",
                   "ops/peer.py", "parallel/wire.py", "parallel/distributed.py",
                   "parallel/halo.py", "parallel/plan.py", "parallel/topology.py",
                   "parallel/step.py", "timeint/leapfrog.py", "timeint/cg.py", "eqn/cli.py",
                   "utils/checkpoint.py", "utils/vtkio.py", "utils/backendprobe.py",
                   "resilience/retry.py", "resilience/faults.py", "resilience/sweepstate.py",
                   "resilience/elastic.py", "resilience/supervisor.py", "tune/space.py",
                   "tune/cache.py", "tune/decide.py", "tune/measure.py", "tune/cli.py",
                   "obs/comm/adjudicate.py", "obs/comm/probe.py", "obs/ledger.py", "obs/metrics.py", "obs/trace.py",
                   "obs/cli.py", "obs/tailer.py", "obs/check.py", "obs/comm/report.py",
                   "obs/perf/profiling.py", "obs/perf/timeline.py",
                   "obs/perf/roofline.py", "obs/perf/merge.py", "obs/perf/regress.py",
                   "analysis/ledgerlint.py", "analysis/findings.py",
                   "analysis/registry.py", "serve/__init__.py", "serve/scenario.py",
                   "serve/ensemble.py", "serve/queue.py", "serve/bench.py", "serve/cli.py",
                   "serve/engine/__init__.py", "serve/engine/core.py", "serve/aot.py",
                   "serve/loadgen.py", "obs/burn.py", "obs/perf/slo.py",
                   "timeint/coeffield.py"):
        assert f"heat3d_tpu_torch/{module}" in names
    assert not _forbidden("heat3d_tpu_torch.ops") and _forbidden("heat3d_tpu.ops")


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, heat3d_tpu_torch, heat3d_tpu_torch.cli, heat3d_tpu_torch.bench, "
        "heat3d_tpu_torch.carry, heat3d_tpu_torch.ops.stencil_direct, "
        "heat3d_tpu_torch.ops.stencil_stream, heat3d_tpu_torch.ops.halo_dma, "
        "heat3d_tpu_torch.parallel.halo, heat3d_tpu_torch.parallel.plan, "
        "heat3d_tpu_torch.parallel.topology, heat3d_tpu_torch.timeint, "
        "heat3d_tpu_torch.eqn.cli, heat3d_tpu_torch.resilience, "
        "heat3d_tpu_torch.resilience.elastic, heat3d_tpu_torch.tune.space, "
        "heat3d_tpu_torch.utils.checkpoint, heat3d_tpu_torch.utils.vtkio, "
        "heat3d_tpu_torch.utils.backendprobe, heat3d_tpu_torch.obs, "
        "heat3d_tpu_torch.obs.cli, heat3d_tpu_torch.obs.tailer, "
        "heat3d_tpu_torch.obs.check, heat3d_tpu_torch.obs.comm.report, "
        "heat3d_tpu_torch.obs.perf, heat3d_tpu_torch.obs.perf.timeline, "
        "heat3d_tpu_torch.obs.perf.roofline, heat3d_tpu_torch.obs.perf.merge, "
        "heat3d_tpu_torch.obs.perf.regress, heat3d_tpu_torch.analysis, "
        "heat3d_tpu_torch.analysis.ledgerlint, heat3d_tpu_torch.analysis.registry, "
        "heat3d_tpu_torch.tune.cache, heat3d_tpu_torch.tune.decide, "
        "heat3d_tpu_torch.tune.measure, heat3d_tpu_torch.tune.cli, "
        "heat3d_tpu_torch.obs.comm.adjudicate, heat3d_tpu_torch.obs.comm.probe, "
        "heat3d_tpu_torch.serve, heat3d_tpu_torch.serve.ensemble, "
        "heat3d_tpu_torch.serve.queue, heat3d_tpu_torch.serve.bench, "
        "heat3d_tpu_torch.serve.cli, heat3d_tpu_torch.timeint.coeffield, "
        "heat3d_tpu_torch.serve.engine, heat3d_tpu_torch.serve.aot, "
        "heat3d_tpu_torch.serve.loadgen, heat3d_tpu_torch.obs.burn, "
        "heat3d_tpu_torch.obs.perf.slo\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'heat3d_tpu', 'ml_dtypes'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_default_device_raises_without_cuda(monkeypatch):
    from heat3d_tpu_torch import GridConfig, HeatSolver3D, SolverConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SolverConfig(grid=GridConfig.cube(8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HeatSolver3D(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HeatSolver3D(cfg, device="cuda")
    from heat3d_tpu_torch.serve import EnsembleSolver, Scenario, ScenarioBatch

    batch = ScenarioBatch(SolverConfig(grid=GridConfig.cube(8), backend="jnp"), [Scenario()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnsembleSolver(batch)
    # the engine does not drop to the CPU either: the chunk fails, visibly
    from heat3d_tpu_torch.serve.engine import AsyncServeEngine

    eng = AsyncServeEngine(autostart=False, aot=False)
    eng.submit(batch.base, Scenario())
    with pytest.raises(RuntimeError, match="failed"):
        list(eng.drain(timeout=60))
    eng.shutdown()
    assert "no CUDA device" in eng.failures[0]["error"]


def test_wrappers_refuse_non_cuda_non_cpu_tensors():
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    u = torch.zeros((8, 8, 8), device="meta")
    taps = sd.np.zeros((3, 3, 3))
    taps[1, 1, 1] = 1.0
    for kernel in (sd.apply_taps_direct, sd.apply_taps_direct2, ss.apply_taps_stream,
                   lambda u, taps: ss.apply_taps_streamk(u, taps, 3),
                   lambda u, taps: ss.apply_taps_stream2(u, taps)):
        with pytest.raises(ValueError, match="no kernel for device"):
            kernel(u, taps)


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

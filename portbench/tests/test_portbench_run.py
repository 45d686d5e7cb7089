"""The command fails, and prints no result, without a card or without
the program beside it; it never falls back to the CPU."""

import os
import shutil
import subprocess
import sys

from portbench import cells

CMD = [sys.executable, "-m", "portbench.run", "--workload", "heat7-fp32-2048x1024x1024.march",
       "--seed", "1", "--seconds", "1", "--trace", "0"]


def _run(cwd, **env):
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(env)
    return subprocess.run(CMD, cwd=cwd, env=full, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


def test_fails_without_a_card():
    proc = _run(cells.ROOT, CUDA_VISIBLE_DEVICES="")
    _no_result(proc)
    assert "CUDA card" in proc.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, CUDA_VISIBLE_DEVICES="")
    _no_result(proc)
    assert "program" in proc.stderr


def test_clears_the_program_knobs(monkeypatch):
    from portbench import run

    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    monkeypatch.setenv("HEAT3D_TUNE_CACHE", "/nonexistent")
    run.fix_environment(cells.ROOT)
    assert [k for k in os.environ if k.startswith("HEAT3D_")] == ["HEAT3D_TUNE_DISABLE"]
    assert os.environ["TRITON_CACHE_DIR"].startswith(str(cells.ROOT))

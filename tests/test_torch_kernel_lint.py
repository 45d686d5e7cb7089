"""The kernel tier (``lint --kernel``) on the CPU, and on the card under
the ``cuda`` marker.

On the CPU the coverage and remote families run the plain versions over
the whole judged matrix; the sanitizer and resources families read "not
certified". The matrix covers every kernel row of ``PERF.md`` §6; the
families are shown not to be blind (a wrapper that skips a cell, writes
past its buffer, or takes a ghost from the wrong shard is flagged); the
sanitizer report parser attributes each report to its case, and a child
that dies in a case is restarted past it. On the card: the seeded racy
kernel is flagged by racecheck, and a clean kernel case is clean.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from heat3d_tpu_torch.analysis.kernel import KERNEL_CHECKERS, coverage, remote, sanitize
from heat3d_tpu_torch.analysis.kernel import run_kernel_checkers
from heat3d_tpu_torch.analysis.kernel.cases import (
    BEGIN,
    END,
    SEEDED,
    SMALL,
    Run,
    case_by_key,
    judged_cases,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = judged_cases()


def test_matrix_covers_every_kernel_row():
    rows = {c.row for c in CASES}
    for row in ("1", "1m", "2", "2m", "3-4", "5-6", "5", "7", "8", "9", "10", "11", "12"):
        assert row in rows, row
    keys = [c.key for c in CASES]
    assert len(keys) == len(set(keys))
    assert all(n % 2 == 1 for n in SMALL)
    assert {c.mesh for c in CASES} == {(1, 1, 1), (2, 2, 2), (8, 1, 1), (4, 1, 1)}
    for family in ("direct", "stream", "fused"):
        mine = [c for c in CASES if c.family == family]
        assert {c.instance() for c in mine} >= {"7pt", "27pt", "generic"}
        assert any(c.compute == "bfloat16" for c in mine)
        assert any(c.storage == "bfloat16" for c in mine)
    assert {c.depth for c in CASES if c.family == "stream"} == {1, 2, 3, 4}
    assert all(c.rdma for c in CASES if c.wrapper.endswith("rdma"))
    full = judged_cases("full")
    assert {c.local for c in full} == {(1024, 1024, 1024), (512, 512, 512),
                                       (128, 1024, 1024)}
    assert case_by_key(full[0].key) == full[0]


def test_kernel_tier_on_the_cpu():
    """``lint --kernel --device cpu --json`` in a child: rc 0, coverage and
    remote clean over the plain versions on every case, each sanitizer
    and resources family "not certified" (a warning)."""
    out = subprocess.run([sys.executable, "-m", "heat3d_tpu_torch", "lint", "--kernel",
                          "--device", "cpu", "--json"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["checkers"] == list(KERNEL_CHECKERS)
    assert payload["counts"]["error"] == 0
    tier = payload["kernel_tier"]
    assert tier["cases"] == [c.key for c in CASES]
    v = tier["verdicts"]
    assert set(v["kernel-coverage"].values()) == {"clean"}
    assert len(v["kernel-coverage"]) == len(CASES)
    assert set(v["kernel-remote"]) == {c.key for c in CASES if c.multi}
    assert set(v["kernel-remote"].values()) == {"clean"}
    for name in ("kernel-memcheck", "kernel-races", "kernel-sync", "kernel-init",
                 "kernel-resources"):
        assert set(v[name].values()) == {"not certified"}
        mine = [f for f in payload["findings"] if f["checker"] == name]
        assert [(f["severity"], f["code"]) for f in mine] == [("warning", "ANL1005")]
        assert "no CUDA device" in mine[0]["message"]


@pytest.mark.parametrize("key", ["direct2-27pt", "stream3-7pt-bf16", "dma-w1-222",
                                 "fused-dma1-811-7pt"])
def test_coverage_flags_a_cell_never_written(monkeypatch, key):
    case = case_by_key(key)
    real = Run.launch

    def skipping(self, outs=None, alloc=None):
        got = real(self, outs, alloc)
        got[-1].view(-1)[5] = float("nan")  # one cell the kernel "forgot"
        return got

    monkeypatch.setattr(Run, "launch", skipping)
    report = {}
    found = coverage.check([case], "cpu", report)
    assert [f.code for f in found] == ["ANL1021"]
    assert report["verdicts"]["kernel-coverage"] == {key: "error"}


def test_coverage_flags_a_store_past_the_buffer(monkeypatch):
    case = case_by_key("direct1-7pt")
    real = Run.launch

    def overrunning(self, outs=None, alloc=None):
        got = real(self, outs, alloc)
        n = got[0].numel()
        torch.as_strided(got[0], (n + 1,), (1,))[n] = 1.0  # one cell too far
        return got

    monkeypatch.setattr(Run, "launch", overrunning)
    found = coverage.check([case], "cpu", {})
    assert [f.code for f in found] == ["ANL1022"]


@pytest.mark.parametrize("key", ["dma-w1-222", "dma-w4-222-bf16", "fused-dma2-811-27pt",
                                 "fused-rdma1-411-7pt"])
def test_remote_flags_a_ghost_from_the_wrong_shard(monkeypatch, key):
    """A mesh whose x neighbour is off by one: the exchange (or the fused
    plain version) takes its ghosts from the wrong shard, the mesh
    disagrees with shift_perm — both flagged."""
    from heat3d_tpu_torch.parallel.topology import ShardMesh

    case = case_by_key(key)
    real = ShardMesh.neighbor

    def skewed(self, shard, axis, direction, periodic):
        nb = real(self, shard, axis, direction, periodic)
        if axis == 0 and nb is not None and self.shape[0] > 2:
            return real(self, nb, axis, direction, True)
        if axis == 0 and nb is not None and self.shape[0] == 2:
            return shard  # a ring of two: its "neighbour" is itself
        return nb

    monkeypatch.setattr(ShardMesh, "neighbor", skewed)
    found = remote.check([case], "cpu", {})
    codes = {f.code for f in found}
    assert "ANL1033" in codes, [f.message for f in found]
    assert codes & {"ANL1031", "ANL1032"}, [f.message for f in found]


def test_remote_clean_and_skips_one_shard():
    report = {}
    picks = [case_by_key(k) for k in ("direct1-7pt", "dma-w4-222", "fused-rdma2-411-27pt")]
    assert remote.check(picks, "cpu", report) == []
    assert report["verdicts"]["kernel-remote"] == {"dma-w4-222": "clean",
                                                   "fused-rdma2-411-27pt": "clean"}


def test_remote_reference_is_the_global_field():
    """The DMA reference cuts the global padded field: on stamped shards a
    ghost region holds its neighbour's stamp, and the bc past a Dirichlet
    face."""
    run = Run(case_by_key("dma-w1-222"), "cpu", stamp=True)
    want = run.reference()
    s0 = want[0]  # shard 0: coords (0,0,0); x neighbour rank 4
    assert float(s0[-1, 5, 5]) == 5.0 and float(s0[0, 5, 5]) == pytest.approx(0.3)
    assert float(s0[5, 5, 5]) == 1.0


_REPORT = f"""
========= COMPUTE-SANITIZER
{BEGIN} a
========= Invalid __global__ write of size 4 bytes
=========     at 0x70 in direct_kernel
=========     by thread (3,0,0) in block (0,0,0)
{END} a ok
{BEGIN} b
========= Warning: Race reported between Write access at 0x10 and Read access at 0x20
{END} b ok
{BEGIN} c
{END} c raised RuntimeError: DMA halo wait timed out
{BEGIN} d
========= Error: Race reported between Write access at 0x10 and Read access at 0x20
=========     in seeded_race_kernel
========= ERROR SUMMARY: 2 errors
"""


def test_sanitizer_report_parser():
    got, outside = sanitize.parse_report(_REPORT)
    assert list(got) == ["a", "b", "c", "d"]
    assert got["a"].status == "ok" and got["a"].errors == [
        "Invalid __global__ write of size 4 bytes"]
    assert got["b"].warnings and not got["b"].errors
    assert got["c"].status.startswith("raised RuntimeError")
    assert got["d"].status is None and got["d"].errors[0].startswith("Error: Race")
    assert outside.errors == []


_FAKE_SANITIZER = """\
#!{python}
# stands in for compute-sanitizer: drops its own flags, runs the child,
# and reports an invalid write inside case 'dma-w1-222'
import subprocess, sys
argv = sys.argv[1:]
child = argv[argv.index("--print-limit") + 2:]
proc = subprocess.Popen(child, stdout=subprocess.PIPE, text=True)
for line in proc.stdout:
    sys.stdout.write(line)
    if line.startswith("{begin} dma-w1-222"):
        sys.stdout.write("========= Invalid __global__ write of size 4 bytes\\n")
    sys.stdout.flush()
sys.exit(proc.wait())
"""


def test_run_tool_restarts_past_a_case_and_attributes_reports(tmp_path):
    """With a stand-in tool over a CPU child (every case raises there: no
    CUDA), each child stops at the case that raised and the next starts
    past it; the injected report lands on its case."""
    exe = tmp_path / "compute-sanitizer"
    exe.write_text(_FAKE_SANITIZER.format(python=sys.executable, begin=BEGIN))
    exe.chmod(0o755)
    keys = ["direct1-7pt", "dma-w1-222", "stream2-27pt"]
    reports, facts = sanitize.run_tool("memcheck", keys, REPO, str(exe), timeout_s=300)
    assert facts["children"] == 3
    assert list(reports) == keys
    assert all(r.status.startswith("raised") for r in reports.values())
    assert reports["dma-w1-222"].errors == ["Invalid __global__ write of size 4 bytes"]
    assert reports["direct1-7pt"].errors == []


_REFUSING_SANITIZER = """\
#!/bin/sh
# stands in for compute-sanitizer on a card it does not support
echo "========= COMPUTE-SANITIZER"
echo "========= Error: Device not supported. Please refer to the \\"Supported Devices\\" section"
echo "{begin} seeded-race"
echo "{end} seeded-race raised AcceleratorError: CUDA error: unknown error"
echo "========= Error: process didn't terminate successfully"
exit 1
"""


def test_a_refused_device_is_not_certified(tmp_path, monkeypatch):
    """The tool refusing the card ("Device not supported") is not a kernel
    fault: one child, every case "not certified" with the tool's words,
    the seeded kernel not certified either (not "unflagged")."""
    exe = tmp_path / "compute-sanitizer"
    exe.write_text(_REFUSING_SANITIZER.format(begin=BEGIN, end=END))
    exe.chmod(0o755)
    reports, facts = sanitize.run_tool("racecheck", [SEEDED, "direct1-7pt"], REPO, str(exe),
                                       timeout_s=60)
    assert facts["children"] == 1 and "Device not supported" in facts["refused"]
    assert all(r.status.startswith("not certified") for r in reports.values())
    # the family's verdict, as on a card the tool refuses
    monkeypatch.setattr(sanitize, "sanitizer_path", lambda: str(exe))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from heat3d_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "build_all", lambda names=None: {})
    report = {}
    found = sanitize.check(["kernel-races"], CASES[:3], REPO, "cuda:0", report)
    assert [(f.code, f.severity) for f in found] == [("ANL1005", "warning")]
    assert "refuses this device" in found[0].message
    assert set(report["verdicts"]["kernel-races"].values()) == {"not certified"}
    assert report["seeded"]["certified"] is False and report["seeded"]["flagged"] is False


# entry names of a real build's compiler report (stencil_direct, _stream,
# _fused): compile-time instances and the interpreted generic kernels
_PTXAS = {
    "stencil_direct": {
        "_ZN50_GLOBAL__N__35b249fd_17_stencil_direct_cu_cbfb79c915direct1_genericIfEEvPKT_"
        "PS1_iiiiif7Program": {"registers": 40, "spill_stores": 0, "spill_loads": 0},
        "_ZN50_GLOBAL__N__35b249fd_17_stencil_direct_cu_cbfb79c913direct_kernelIfLi2ELi3E"
        "8Bf16MathEEvPKT_PS3_iiiii7Program": {"registers": 80, "spill_stores": 4,
                                             "spill_loads": 4},
    },
    "stencil_stream": {
        "_ZN50_GLOBAL__N__4d7c09ca_17_stencil_stream_cu_dd3a37df15streamk_genericIfLi3EEEvPKT_"
        "PS1_iiiiifi7Program": {"registers": 32, "spill_stores": 8, "spill_loads": 8},
    },
    "stencil_fused": {
        "_ZN49_GLOBAL__N__6c7342df_16_stencil_fused_cu_3e2fcd3f12fused_kernelIfLi2EEEv9"
        "FusedArgsPj": {"registers": 64, "spill_stores": 0, "spill_loads": 0},
    },
}


def test_resources_reads_spills_of_every_instance(monkeypatch):
    """Spills by instance from the compiler's report: the compile-time
    templates by (depth, code, policy), the generic kernels by their own
    names."""
    from heat3d_tpu_torch.analysis.kernel import resources
    from heat3d_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "ptxas_report", lambda lib: _PTXAS.get(lib, {}))
    assert resources._spills("direct", 1, 0, "float32", False)["registers"] == 40
    assert resources._spills("direct", 2, 3, "float32", True)["spill_stores"] == 4
    assert resources._spills("direct", 2, 3, "float32", False) is None
    assert resources._spills("stream", 3, 0, "float32", False)["spill_loads"] == 8
    assert resources._spills("stream", 2, 0, "float32", False) is None
    assert resources._spills("fused", 2, 0, "float32", True)["registers"] == 64


def test_float_zeros_from_makes_only_float_buffers():
    """The fused state's landing buffers (float zeros) come from the
    sentinel allocator for the block; its flag words and counters (ints)
    and every call after it are real zeros."""
    from heat3d_tpu_torch.analysis.kernel.cases import _float_zeros_from

    g = coverage.Guarded()
    with _float_zeros_from(g.alloc):
        land = torch.zeros((2, 3, 5), dtype=torch.float32, device="cpu")
        flags = torch.zeros(8, dtype=torch.int64, device="cpu")
    assert torch.isnan(land).all() and land.shape == (2, 3, 5)
    assert flags.eq(0).all() and len(g.buffers) == 1
    assert torch.zeros(2).eq(0).all()


def test_families_without_a_device_are_not_certified():
    found = run_kernel_checkers(REPO, ["kernel-races", "kernel-resources"], device="cpu",
                                cases=CASES[:2])
    assert [(f.checker, f.code, f.severity) for f in found] == [
        ("kernel-races", "ANL1005", "warning"),
        ("kernel-resources", "ANL1005", "warning")]


def test_seeded_kernel_source_has_the_race():
    src = open(os.path.join(REPO, "heat3d_tpu_torch", "analysis", "kernel", "seeded.cu")).read()
    body = src.split("seeded_race_kernel(float* out) {")[1].split("}")[0]
    assert "ring[i] =" in body and "ring[(i + 32)" in body
    assert "__syncthreads" not in body
    from heat3d_tpu_torch.ops import _build

    assert "seeded_race" in _build.EXTRA_SOURCES
    assert _build.source("seeded_race").name == "seeded.cu"
    assert "seeded_race" not in {p.stem for p in _build.CSRC_DIR.glob("*.cu")}


@pytest.fixture
def sanitizer():
    """The card and its compute-sanitizer, or a skip naming what is
    missing (decided in the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel tier's sanitizer runs on the GPU)")
    exe = sanitize.sanitizer_path()
    if exe is None:
        pytest.skip("the CUDA toolkit has no compute-sanitizer")
    return exe


@pytest.mark.cuda
def test_racecheck_flags_the_seeded_kernel_on_the_card(sanitizer):
    reports, facts = sanitize.run_tool("racecheck", [SEEDED, "direct1-7pt"], REPO,
                                       sanitizer, timeout_s=600)
    if facts["refused"]:
        pytest.skip(f"compute-sanitizer refuses this device: {facts['refused']}")
    assert reports[SEEDED].status == "ok"
    assert reports[SEEDED].errors or reports[SEEDED].warnings
    assert reports["direct1-7pt"].status == "ok"


@pytest.mark.cuda
def test_memcheck_report_parser_on_the_card(sanitizer):
    reports, facts = sanitize.run_tool("memcheck", ["direct2-27pt", "dma-w1-222"], REPO,
                                       sanitizer, timeout_s=600)
    if facts["refused"]:
        pytest.skip(f"compute-sanitizer refuses this device: {facts['refused']}")
    for key in ("direct2-27pt", "dma-w1-222"):
        assert reports[key].status == "ok" and reports[key].errors == []

"""The port's ``bench/report.py`` against the JAX package's (tier-1, CPU):
the same JSONL renders byte-equal tables in both, the measured block
between the same markers; rows of the port's harness render."""

import json

from heat3d_tpu.bench import report as ref_report
from heat3d_tpu_torch.bench import report

ROWS = [
    {"bench": "throughput", "grid": [64, 64, 64], "mesh": [1, 1, 1], "stencil": "7pt",
     "dtype": "float32", "backend": "pallas", "time_blocking": 2, "steps": 20,
     "gcell_per_sec": 12.5, "gcell_per_sec_per_chip": 12.5, "direct_path": True,
     "chain_ops": 11, "mehrstellen_route": False, "rtt_dominated": False},
    {"bench": "throughput", "grid": [64, 64, 64], "mesh": [2, 1, 1], "stencil": "7pt",
     "dtype": "float32", "backend": "pallas", "time_blocking": 2, "steps": 20,
     "gcell_per_sec": 20.0, "gcell_per_sec_per_chip": 10.0, "fused_dma_path": True,
     "fused_dma_emulated": False, "chain_ops": 11},
    {"bench": "throughput", "grid": [32, 32, 32], "mesh": [1, 1, 1], "stencil": "7pt",
     "dtype": "float32", "backend": "pallas", "time_blocking": 2, "steps": 20,
     "gcell_per_sec": 9.0, "gcell_per_sec_per_chip": 9.0},
    {"bench": "throughput", "grid": [48, 48, 48], "mesh": [1, 1, 1], "stencil": "27pt",
     "dtype": "bfloat16", "compute_dtype": "bfloat16", "backend": "conv",
     "time_blocking": 1, "steps": 5, "gcell_per_sec": 1.25,
     "gcell_per_sec_per_chip": 1.25, "rtt_dominated": True},
    {"bench": "halo", "grid": [64, 64, 64], "mesh": [2, 2, 2], "dtype": "float32",
     "p50_us": 120.5, "p95_mean_us": 130.25, "min_us": 100.0,
     "halo_bytes_per_device": 4096, "ici": True},
    {"bench": "halo", "grid": [64, 64, 64], "mesh": [1, 1, 1], "dtype": "float32",
     "p50_us": 80.0, "p95_us": 90.0, "min_us": 70.0, "halo_bytes_per_device": 2048},
]


def _jsonl(tmp_path, rows, extra=()):
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows) + "".join(extra))
    return str(path)


def test_same_jsonl_renders_byte_equal(tmp_path, capsys):
    path = _jsonl(tmp_path, ROWS, ["{not json\n", json.dumps({"note": "x"}) + "\n"])
    mine, ref = report.load_results(path), ref_report.load_results(path)
    assert mine == ref and len(mine) == len(ROWS)
    assert report.render(mine) == ref_report.render(ref)
    assert report.scaling_rows(mine) == ref_report.scaling_rows(ref)
    assert report.render([]) == ref_report.render([])
    capsys.readouterr()


def test_update_writes_the_same_block(tmp_path, capsys):
    path = _jsonl(tmp_path, ROWS)
    a, b = tmp_path / "a.md", tmp_path / "b.md"
    for md in (a, b):
        md.write_text(f"# Doc\n\nintro\n\n{report.BEGIN}\nold\n{report.END}\n\ntail\n")
    assert report.main([path, str(a)]) == 0
    assert ref_report.main([path, str(b)]) == 0
    assert a.read_text() == b.read_text()
    assert a.read_text().count(report.BEGIN) == 1 and "tail" in a.read_text()
    assert (report.BEGIN, report.END) == (ref_report.BEGIN, ref_report.END)
    out = capsys.readouterr().out
    assert "updated" in out


def test_no_results_keep_the_measured_block(tmp_path, capsys):
    md = tmp_path / "m.md"
    md.write_text(f"{report.BEGIN}\nreal table\n{report.END}\n")
    assert report.main([str(tmp_path / "missing.jsonl"), str(md)]) == 0
    assert "real table" in md.read_text()
    assert "kept" in capsys.readouterr().out


def test_without_a_file_the_tables_go_to_stdout(tmp_path, capsys):
    path = _jsonl(tmp_path, ROWS)
    assert report.main([path]) == 0
    out = capsys.readouterr().out
    assert out == report.render(report.load_results(path)) + "\n"
    assert "### Throughput (measured)" in out and "### Halo exchange (measured)" in out
    assert report.main([]) == 2


def test_port_harness_rows_render(tmp_path):
    import torch

    from heat3d_tpu_torch.bench.harness import halo_row, throughput_row
    from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig

    dev = [torch.device("cpu")]
    rows = []
    for mesh in ((1, 1, 1), (2, 1, 1)):
        cfg = SolverConfig(grid=GridConfig.cube(16), mesh=MeshConfig(shape=mesh),
                           time_blocking=2)
        n = mesh[0] * mesh[1] * mesh[2]
        rows.append(throughput_row(cfg, steps=8, steps_requested=8, times=[0.02, 0.01],
                                   devices=dev, shards=n, sync_rtt_s=1e-5,
                                   kernel_launches={}))
        rows.append(halo_row(cfg, k=25, iters=2, times=[1e-4, 2e-4], devices=dev, shards=n,
                             sync_rtt_s=1e-5))
    path = _jsonl(tmp_path, rows)
    got = report.render(report.load_results(path))
    assert got == ref_report.render(ref_report.load_results(path))
    # two throughput rows, the strong-scaling row of (2,1,1), two halo rows
    assert got.count("| 16³ |") == 5 and "### Scaling efficiency" in got

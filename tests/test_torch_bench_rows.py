"""The port's throughput rows against the JAX package's provenance lint.

``heat3d_tpu_torch.bench.harness.throughput_row`` builds a row from a run's
timings without timing anything, so a row of every route can be built on
the CPU and fed to ``heat3d_tpu.analysis.provenance.check_row``, the lint
behind ``scripts/check_provenance.py`` and ``obs regress``. Each row must
pass with no finding, and its route fields must name the route that ran.
"""

import pytest
import torch

from heat3d_tpu.analysis.provenance import check_row
from heat3d_tpu_torch.bench.harness import throughput_row
from heat3d_tpu_torch.core.config import (
    GridConfig, MeshConfig, SolverConfig, StencilConfig,
)
from heat3d_tpu_torch.ops.stencil_direct import chain_ops
from heat3d_tpu_torch.eqn import solver_taps
from heat3d_tpu_torch.parallel.step import step_route, superstep_route

# (id, SolverConfig keyword arguments, HEAT3D_NO_DIRECT, the route that runs)
CASES = [
    ("direct-tb2", {"time_blocking": 2}, False, "direct2"),
    ("direct-tb1-27pt", {"stencil": StencilConfig(kind="27pt")}, False, "direct"),
    ("exchange-tb4", {"time_blocking": 4}, False, "streamk"),
    ("no-direct-tb1", {}, True, "exchange"),
    ("no-direct-tb2", {"time_blocking": 2}, True, "streamk"),
    ("mesh222-dma-tb1", {"mesh": MeshConfig(shape=(2, 2, 2)), "halo": "dma"}, False,
     "exchange"),
    ("mesh222-dma-tb4", {"mesh": MeshConfig(shape=(2, 2, 2)), "halo": "dma",
                         "time_blocking": 4}, False, "streamk"),
    ("mesh811-dma-overlap", {"mesh": MeshConfig(shape=(8, 1, 1)), "halo": "dma",
                             "overlap": True}, False, "fused-dma"),
    ("mesh811-dma-overlap-tb2", {"mesh": MeshConfig(shape=(8, 1, 1)), "halo": "dma",
                                 "overlap": True, "time_blocking": 2}, False, "fused-dma2"),
    ("mesh222-ppermute-tb2", {"mesh": MeshConfig(shape=(2, 2, 2)), "time_blocking": 2},
     False, "faces-direct2"),
    ("conv", {"backend": "conv"}, False, "exchange"),
]


def _row(monkeypatch, kwargs, no_direct):
    if no_direct:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    else:
        monkeypatch.delenv("HEAT3D_NO_DIRECT", raising=False)
    cfg = SolverConfig(grid=GridConfig.cube(32), **kwargs)
    shards = cfg.mesh.shape[0] * cfg.mesh.shape[1] * cfg.mesh.shape[2]
    row = throughput_row(cfg, steps=8, steps_requested=5, times=[0.02, 0.01, 0.03],
                         devices=[torch.device("cpu")], shards=shards,
                         sync_rtt_s=2e-5, kernel_launches={})
    return cfg, row


@pytest.mark.parametrize("kwargs,no_direct,route",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_row_passes_provenance_lint(monkeypatch, kwargs, no_direct, route):
    cfg, row = _row(monkeypatch, kwargs, no_direct)
    assert check_row(row) == []
    ran = superstep_route(cfg) if cfg.time_blocking > 1 else step_route(cfg)
    assert ran == route
    assert row["direct_path"] == (route in ("direct", "direct2"))
    assert row["streamk_path"] == (route == "streamk")
    assert row["fused_dma_path"] == route.startswith("fused-dma")
    assert row["fused_rdma_path"] is False
    assert row["mehrstellen_route"] is False
    assert not (row["fused_dma_emulated"] or row["streamk_emulated"]
                or row["fused_rdma_emulated"])
    if cfg.backend == "conv":
        assert row["chain_ops"] is None
    else:
        assert row["chain_ops"] == chain_ops(solver_taps(cfg))


def test_row_numbers_come_from_the_timings(monkeypatch):
    """The row states the timings it was given: the best run, its Gcell/s
    over the global grid, ms per superstep (8 steps at tb=2: 4 launches),
    the sync RTT, and a CPU platform for a row built off the card."""
    cfg, row = _row(monkeypatch, {"time_blocking": 2}, False)
    assert row["seconds_best"] == 0.01
    assert row["gcell_updates_per_sec"] == pytest.approx(32**3 * 8 / 0.01 / 1e9)
    assert row["launches_per_run"] == 4
    assert row["ms_per_launch"] == pytest.approx(0.01 / 4 * 1e3)
    assert row["sync_rtt_s"] == 2e-5
    assert row["platform"] == "cpu"
    assert row["steps"] == 8 and row["steps_requested"] == 5


def test_chain_ops_counts_the_emission_program(monkeypatch):
    """13 ops for the 7pt chain (7 products, 6 sums); the factored 27pt
    chain: 12 products, 11 sums, one x-plane sum and two y-row sums (of the
    x-sum plane and of the middle plane) = 26; factoring off takes more."""
    monkeypatch.delenv("HEAT3D_FACTOR_7PT", raising=False)
    monkeypatch.setenv("HEAT3D_FACTOR_Y", "1")
    taps7 = solver_taps(SolverConfig(grid=GridConfig.cube(16)))
    taps27 = solver_taps(SolverConfig(grid=GridConfig.cube(16),
                                      stencil=StencilConfig(kind="27pt")))
    assert chain_ops(taps7) == 13
    assert chain_ops(taps27) == 26
    monkeypatch.setenv("HEAT3D_FACTOR_Y", "0")
    assert chain_ops(taps27) > 26

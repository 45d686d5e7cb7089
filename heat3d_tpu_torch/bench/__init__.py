"""Benchmark harness: Gcell-updates/s of the solver loop on the GPU."""

from heat3d_tpu_torch.bench.harness import bench_throughput  # noqa: F401

"""Always-on async serving engine.

Port of ``heat3d_tpu.serve.engine``: the continuously-batching
counterpart of :class:`~heat3d_tpu_torch.serve.queue.ScenarioQueue`.
Submissions are accepted WHILE batches execute — a dispatcher loop packs
pending requests into shape-bucketed batches and hands them to per-bucket
worker threads, each of which builds (and warms, serve/aot.py) its
bucket's ensemble once and runs one batch at a time on CUDA streams of
its own. Results deliver in submission order per request stream;
per-bucket latency stats, backpressure caps, and the drain-final
``serve_metrics_summary`` event are shared with the synchronous queue, so
the SLO layer judges both front-ends identically.
"""

from heat3d_tpu_torch.serve.engine.core import (  # noqa: F401
    AsyncServeEngine,
    DEFAULT_WORKERS,
    ENV_WORKERS,
    is_backend_loss,
)

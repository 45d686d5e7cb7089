"""Static analysis of the port: SPMD-safety and invariant lints.

Five AST/registry checkers over the port's own source (the catalog is
``heat3d_tpu_torch/docs/ANALYSIS.md``), one shared finding/severity/
suppression framework (:mod:`~heat3d_tpu_torch.analysis.findings`), the
data lints over ledgers (:mod:`~heat3d_tpu_torch.analysis.ledgerlint`)
and bench rows (:mod:`~heat3d_tpu_torch.analysis.provenance`), and the
kernel tier (:mod:`~heat3d_tpu_torch.analysis.kernel`, ``lint
--kernel``), which runs every CUDA kernel instance of the port under
``compute-sanitizer`` and against NaN sentinels and stamped shards on the
card. ``python -m heat3d_tpu_torch lint`` (:mod:`~heat3d_tpu_torch.
analysis.cli`) is the entry point (``--all`` = both tiers, one merged
verdict): rc 1 only on unsuppressed error-severity findings.

The source checkers parse, they do not import, the code they audit —
except where the live surfaces themselves are the artifact under audit
(the knob and equation registries, the CLI parser), which are loaded
deliberately. The JAX package's IR tier (traced programs) has no
counterpart: the port builds no traced programs.
"""

from __future__ import annotations

from heat3d_tpu_torch.analysis.findings import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    Finding,
)

# checker name -> module path (the CLI resolves lazily so one checker's
# run imports nothing the others need)
CHECKERS = {
    "collective-divergence": "heat3d_tpu_torch.analysis.collectives",
    "fail-soft": "heat3d_tpu_torch.analysis.failsoft",
    "ledger-taxonomy": "heat3d_tpu_torch.analysis.taxonomy",
    "knob-drift": "heat3d_tpu_torch.analysis.knobs",
    "eqn-registry": "heat3d_tpu_torch.analysis.eqnlint",
}

"""Analysis: the ledger data lint (``obs check``, ``obs check
--taxonomy``) over the run ledger, with its finding record and the
canonical event registry. The JAX package's source and IR checkers are
not ported."""

from heat3d_tpu_torch.analysis.findings import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    Finding,
)

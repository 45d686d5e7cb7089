"""Ledger schema lint — the names ``obs check`` imports. The
implementation lives in :mod:`heat3d_tpu_torch.analysis.ledgerlint` (the
analysis package owns the data-lint cores and their finding format).
"""

from __future__ import annotations

from heat3d_tpu_torch.analysis.ledgerlint import (  # noqa: F401
    EPS,
    MAX_REPORT,
    Defect,
    _check_event,
    _check_nesting,
    check_file,
    check_file_findings,
    main,
)

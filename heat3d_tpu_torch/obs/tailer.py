"""Incremental ledger tailing: the input layer for live observability.

``obs tail --follow``, ``obs check --follow``, ``obs watch``, and the soak
monitor all need to read a ledger *while it is being written* without
re-reading the whole file per tick. :class:`LedgerTailer` keeps a byte
offset into the active file plus a count of fully-consumed rolled segments
(``HEAT3D_LEDGER_MAX_MB`` rotation renames the base aside, preserving byte
offsets), so each :meth:`poll` returns exactly the lines appended since the
last one — across rotations, with no duplicates and no loss.

Partial lines (a poll racing the writer mid-line) are buffered and
completed on the next poll. All IO errors fail soft: a poll that cannot
read returns what it has and tries again next tick — a live viewer must
never crash the run it watches (nor itself) over a transient read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from heat3d_tpu_torch.obs.ledger import ledger_segments


class LedgerTailer:
    """Stateful incremental reader over one (possibly rotating) ledger."""

    def __init__(self, path: str):
        self.path = path
        self._consumed_rolled = 0  # rolled segments fully consumed
        self._offset = 0  # byte offset into the current file
        self._buf = ""  # partial trailing line awaiting its remainder

    # ---- raw line layer --------------------------------------------------

    def _read_from(self, path: str, offset: int) -> Tuple[Optional[str], int]:
        try:
            with open(path) as f:
                f.seek(offset)
                data = f.read()
                return data, f.tell()
        except OSError:
            return None, offset

    def _split(self, data: str) -> List[str]:
        data = self._buf + data
        lines = data.split("\n")
        self._buf = lines.pop()  # "" when data ended on a newline
        return [ln for ln in (s.strip() for s in lines) if ln]

    def poll_lines(self) -> List[str]:
        """Complete raw lines appended since the last poll (oldest first)."""
        out: List[str] = []
        rolled = ledger_segments(self.path)[:-1]
        # drain segments that rolled since the last poll: the rename kept
        # their bytes, so the saved base offset points into the first one
        while self._consumed_rolled < len(rolled):
            data, _ = self._read_from(
                rolled[self._consumed_rolled], self._offset
            )
            if data is None:
                return out  # transient; retry next poll
            out.extend(self._split(data))
            self._consumed_rolled += 1
            self._offset = 0
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return out
        if size < self._offset:  # base replaced/truncated out-of-band
            self._offset = 0
            self._buf = ""
        if size > self._offset:
            data, end = self._read_from(self.path, self._offset)
            if data is None:
                return out
            # a rotation racing this read means `data` may belong to either
            # the old or the new base: discard it (the bytes survive in the
            # rolled segment, which the next poll drains from our offset)
            if len(ledger_segments(self.path)) - 1 != self._consumed_rolled:
                return out
            out.extend(self._split(data))
            self._offset = end
        return out

    # ---- parsed layer ----------------------------------------------------

    def poll(self) -> List[Dict[str, Any]]:
        """Parsed events appended since the last poll; unparseable lines
        are skipped (use :meth:`poll_lines` to see them)."""
        out: List[Dict[str, Any]] = []
        for line in self.poll_lines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

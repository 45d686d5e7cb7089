"""The run ledger: an append-only JSONL event stream for every entry point.

The resilience layer makes failures survivable; this makes them
*explainable*. A supervised
run that heals and resumes, a bench sweep that journals half its rows and
is SIGTERM'd, a checkpoint generation that quarantines — each leaves a
machine-readable record of what happened, when, and at what cost, in one
place: the ledger file. ``obs check`` lints it,
``heat3d obs summary`` turns it into timelines and p50/p95 tables, and the
resilience tests assert observability of the failures they inject.

Event shape (one JSON object per line, append-only, flushed per event)::

    {"ts": <wall unix seconds at write>, "run_id": "...", "proc": 0,
     "seq": 7, "event": "<name>", "kind": "point" | "span", ...fields}

Span events additionally carry ``t0``/``t1`` (``time.monotonic`` bounds —
immune to wall-clock steps, comparable only within one process), ``dur_s``,
``depth`` (nesting level at open), and ``status`` (``ok`` | ``error``).
Spans are written AT CLOSE, so file order is end-time order and parent
spans appear after their children — the lint's nesting check and the
summary's timeline both rely on this.

Activation: entry points call :func:`activate` with their ``--ledger``
flag; library code calls :func:`get` unconditionally and writes through
whatever is active. With no flag, ``HEAT3D_LEDGER=<path>`` activates the
ledger from the environment (how a sweep script threads one ledger
through every row's subprocess); with neither, :func:`get` returns the
:data:`NULL` ledger and every hook is a cheap no-op.

Context tagging: ``set_context(generation=8)`` merges fields into every
subsequent event (the supervisor tags its current generation this way), so
a heal/resume session is reconstructable from the ledger alone.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, Optional

ENV_LEDGER = "HEAT3D_LEDGER"
ENV_LEDGER_MAX_MB = "HEAT3D_LEDGER_MAX_MB"
SCHEMA_VERSION = 1

# Fields every event must carry (the contract analysis/ledgerlint.py
# enforces — change them together).
REQUIRED_FIELDS = ("ts", "run_id", "proc", "seq", "event", "kind")
SPAN_FIELDS = ("t0", "t1", "dur_s", "depth", "status")


def _process_index() -> int:
    """The process's rank: ``torch.distributed.get_rank()`` when a process
    group is initialized, else 0. Never initializes CUDA (an early CUDA
    start would pin the device before the entry point picks one)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
        return 0
    except (ImportError, AttributeError, RuntimeError, ValueError):
        # torch absent or its distributed state not queryable: degrade to
        # 0, never crash activate
        return 0


def _new_run_id() -> str:
    return uuid.uuid4().hex[:12]


def _segment_path(path: str, idx: int) -> str:
    """Rolled-segment naming: ``ledger.jsonl`` rolls to ``ledger.0.jsonl``,
    ``ledger.1.jsonl``, ... (oldest first); the base path is always the
    active file."""
    stem, ext = os.path.splitext(path)
    return f"{stem}.{idx}{ext}" if ext else f"{path}.{idx}"


def _env_max_bytes() -> int:
    """Rotation cap from ``HEAT3D_LEDGER_MAX_MB`` (float MB; unset,
    unparseable, or <= 0 disables rotation)."""
    raw = os.environ.get(ENV_LEDGER_MAX_MB, "")
    if not raw:
        return 0
    try:
        mb = float(raw)
    except ValueError:
        return 0
    return int(mb * 1e6) if mb > 0 else 0


def ledger_segments(path: str) -> "list[str]":
    """All on-disk segments of a (possibly rotated) ledger, oldest first,
    the active base path last. With no rolled siblings this is just
    ``[path]`` — readers can call it unconditionally."""
    out = []
    i = 0
    while True:
        seg = _segment_path(path, i)
        if not os.path.exists(seg):
            break
        out.append(seg)
        i += 1
    out.append(path)
    return out


class SpanHandle:
    """Mutable view of an in-flight span: ``add(**fields)`` attaches fields
    to the record written at close; ``dur_s`` is readable after the span
    exits (callers feed it to the metrics registry)."""

    def __init__(self) -> None:
        self.fields: Dict[str, Any] = {}
        self.dur_s: Optional[float] = None

    def add(self, **fields: Any) -> None:
        self.fields.update(fields)


class _SpanCtx:
    def __init__(self, ledger: "Ledger", name: str, fields: Dict[str, Any]):
        self._ledger = ledger
        self._name = name
        self._fields = fields
        self.handle = SpanHandle()

    def __enter__(self) -> SpanHandle:
        self._t0 = time.monotonic()
        self._depth = self._ledger._enter_span()
        return self.handle

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.monotonic()
        self.handle.dur_s = t1 - self._t0
        self._ledger._exit_span()
        status = "ok" if exc_type is None else "error"
        fields = dict(self._fields)
        fields.update(self.handle.fields)
        if exc_type is not None:
            fields.setdefault(
                "error", f"{exc_type.__name__}: {str(exc)[:200]}"
            )
        span_fields = {
            "t0": self._t0,
            "t1": t1,
            "dur_s": self.handle.dur_s,
            "depth": self._depth,
            "status": status,
        }
        span_fields.update(
            (k, v) for k, v in fields.items() if k not in span_fields
        )
        self._ledger._write(self._name, "span", span_fields)
        return False  # never swallow


class Ledger:
    """Append-only JSONL event stream for one process.

    Thread-safe for writes (one lock); span DEPTH is tracked per thread so
    a background thread's spans cannot corrupt the main thread's nesting.
    The file is opened in append mode and flushed per event — a crash
    (SIGKILL, backend wedge) loses at most the event being written, and a
    relaunched run appends a new ``run_id`` segment to the same file.
    """

    def __init__(
        self,
        path: str,
        run_id: Optional[str] = None,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.path = path
        self.run_id = run_id or _new_run_id()
        self._lock = threading.Lock()
        self._seq = 0
        self._ctx: Dict[str, Any] = {}
        self._depth = threading.local()
        # pinned ONCE at open: re-resolving per event would flip proc from
        # 0 (pre-backend-init) to the real index mid-stream, splitting one
        # stream into two (run_id, proc) lint keys. Entry points activate
        # after distributed.initialize, so the resolution here is final.
        self.proc = _process_index()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        # size-capped rotation (HEAT3D_LEDGER_MAX_MB): one continuous
        # (run_id, proc, seq) stream spans the rolled segments, so the
        # lint's per-stream checks hold on the concatenation
        self._max_bytes = _env_max_bytes()
        self._rolled = 0
        while os.path.exists(_segment_path(path, self._rolled)):
            self._rolled += 1
        try:
            self._bytes = self._f.tell()
        except OSError:
            self._bytes = 0
        open_fields = {
            "schema": SCHEMA_VERSION,
            "pid": os.getpid(),
            "argv": list(sys.argv)[:12],
        }
        open_fields.update(meta or {})
        self._write("ledger_open", "point", open_fields)

    # ---- span-depth bookkeeping (per thread) -----------------------------

    def _enter_span(self) -> int:
        depth = getattr(self._depth, "v", 0)
        self._depth.v = depth + 1
        return depth

    def _exit_span(self) -> None:
        self._depth.v = max(getattr(self._depth, "v", 1) - 1, 0)

    # ---- the write path --------------------------------------------------

    def _write(self, name: str, kind: str, fields: Dict[str, Any]) -> None:
        with self._lock:
            if self._f.closed:  # post-close stragglers: drop, don't crash
                return
            record = {
                "ts": time.time(),
                "run_id": self.run_id,
                "proc": self.proc,
                "seq": self._seq,
                "event": name,
                "kind": kind,
            }
            # precedence: envelope > explicit event fields > ambient context
            for src in (fields, self._ctx):
                for k, v in src.items():
                    if k not in record:
                        record[k] = v
            self._seq += 1
            try:
                line = json.dumps(record, default=repr)
            except Exception:  # noqa: BLE001 - default=repr runs arbitrary
                # __repr__, so any exception class can surface here
                # a bad field must not kill the run being observed — AND
                # the salvage record must stay schema-valid (a span
                # stripped of its span fields would fail the project's own
                # lint and fail the bench suite): salvage per field,
                # dropping only the unserializable ones. The envelope and
                # span fields are self-constructed primitives and always
                # survive.
                salvaged = {}
                dropped = []
                for k, v in record.items():
                    try:
                        json.dumps(v, default=repr)
                        salvaged[k] = v
                    except Exception:  # noqa: BLE001 - same repr exposure
                        dropped.append(k)
                salvaged["malformed_fields"] = dropped
                try:
                    line = json.dumps(salvaged, default=repr)
                except Exception:  # noqa: BLE001
                    # a value whose repr itself raises: drop to the
                    # envelope alone, hand-formatted — the fields are
                    # self-constructed primitives, so this cannot raise
                    # and the record stays schema-valid
                    line = (
                        '{"ts": %r, "run_id": "%s", "proc": %d, "seq": %d,'
                        ' "event": "%s", "kind": "%s",'
                        ' "salvage_failed": true}'
                        % (
                            record["ts"], record["run_id"], record["proc"],
                            record["seq"], record["event"], record["kind"],
                        )
                    )
            try:
                self._f.write(line + "\n")
                self._f.flush()
                self._bytes += len(line) + 1
                if self._max_bytes and self._bytes >= self._max_bytes:
                    self._rotate_locked()
            except (OSError, ValueError) as e:
                # telemetry must never kill the run it observes: a failed
                # write (disk full, path gone read-only mid-run) disables
                # the ledger — one stderr note, every later event dropped
                try:
                    self._f.close()
                except OSError:
                    pass
                print(
                    f"heat3d: ledger {self.path} disabled "
                    f"({type(e).__name__}: {e}); further events dropped",
                    file=sys.stderr,
                )

    def _rotate_locked(self) -> None:
        """Roll the active file aside (``ledger.N.jsonl``, oldest ``.0``)
        and reopen the base path fresh; called under ``self._lock`` after a
        successful write. The rename preserves byte content, so a tailer's
        saved offset into the old base carries into the rolled segment.
        Fail-soft: any OSError disables rotation (one stderr note) and the
        ledger keeps appending to whatever file is open."""
        try:
            self._f.close()
            os.replace(self.path, _segment_path(self.path, self._rolled))
            self._rolled += 1
            self._f = open(self.path, "a")
            self._bytes = 0
        except OSError as e:
            self._max_bytes = 0
            print(
                f"heat3d: ledger rotation for {self.path} disabled "
                f"({type(e).__name__}: {e})",
                file=sys.stderr,
            )
            try:
                if self._f.closed:
                    self._f = open(self.path, "a")
            except OSError:
                pass  # next _write sees a closed file and drops, per fail-soft

    # ---- public API ------------------------------------------------------

    def set_context(self, **fields: Any) -> None:
        """Merge ``fields`` into every subsequent event (``None`` deletes
        a key) — run-scoped tags like the supervisor's current generation."""
        for k, v in fields.items():
            if v is None:
                self._ctx.pop(k, None)
            else:
                self._ctx[k] = v

    def event(self, name: str, **fields: Any) -> None:
        """Write one point event. Field names colliding with the envelope
        (ts/run_id/proc/seq/event/kind) are dropped by the envelope-first
        merge in ``_write`` — spell them differently (e.g. ``kind_``)."""
        self._write(name, "point", fields)

    def span(self, name: str, **fields: Any) -> _SpanCtx:
        """Context manager timing a region; writes one span event at exit
        (status ``error`` + the exception's repr if the body raised —
        re-raised, never swallowed). Yields a :class:`SpanHandle`."""
        return _SpanCtx(self, name, fields)

    def close(self, **fields: Any) -> None:
        self._write("ledger_close", "point", fields)
        with self._lock:
            try:
                self._f.close()
            except OSError as e:
                # close flushes; ENOSPC at the final flush must not turn
                # a completed run's exit path into a crash (the fail-soft
                # invariant heat3d lint enforces on this surface)
                print(
                    f"heat3d: ledger {self.path} close failed ({e})",
                    file=sys.stderr,
                )

    @property
    def active(self) -> bool:
        return True


class NullLedger:
    """The inactive ledger: same surface, no IO — library code calls
    ``obs.get().event(...)`` unconditionally and pays one attribute check
    when no ledger is configured."""

    path = None
    run_id = None
    active = False

    def set_context(self, **fields: Any) -> None:
        pass

    def event(self, name: str, **fields: Any) -> None:
        pass

    def span(self, name: str, **fields: Any) -> "_NullSpanCtx":
        return _NullSpanCtx()

    def close(self, **fields: Any) -> None:
        pass


class _NullSpanCtx:
    def __enter__(self) -> SpanHandle:
        self._t0 = time.monotonic()
        self.handle = SpanHandle()
        return self.handle

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.handle.dur_s = time.monotonic() - self._t0
        return False


NULL = NullLedger()
_active: Optional[Ledger] = None
_env_checked = False


def activate(
    path: Optional[str] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> "Ledger | NullLedger":
    """Open the process ledger at ``path`` (or ``$HEAT3D_LEDGER`` when
    ``path`` is None) and make it the one :func:`get` returns. With
    neither configured, leaves the NULL ledger active. Idempotent per
    path: re-activating the already-active path is a no-op."""
    global _active, _env_checked
    _env_checked = True
    path = path or os.environ.get(ENV_LEDGER) or None
    if not path:
        return _active or NULL
    if _active is not None and _active.path == path:
        return _active
    if _active is not None:
        _active.close(reason="reactivated")
    try:
        _active = Ledger(path, meta=meta)
    except OSError as e:
        # an unwritable ledger path must fail soft at whatever call site
        # triggered activation (env-lazy get() can be deep inside library
        # code) — the run proceeds unledgered, loudly
        print(
            f"heat3d: cannot open ledger {path} ({e}); running without one",
            file=sys.stderr,
        )
        _active = None
        return NULL
    return _active


def get() -> "Ledger | NullLedger":
    """The active ledger (env-activated on first call when
    ``HEAT3D_LEDGER`` is set), or the no-op NULL ledger."""
    global _env_checked
    if _active is None and not _env_checked:
        _env_checked = True
        if os.environ.get(ENV_LEDGER):
            return activate()
    return _active or NULL


def deactivate(**fields: Any) -> None:
    """Close and detach the active ledger (entry points' exit path; also
    what tests use to isolate ledgers)."""
    global _active, _env_checked
    if _active is not None:
        _active.close(**fields)
    _active = None
    _env_checked = False

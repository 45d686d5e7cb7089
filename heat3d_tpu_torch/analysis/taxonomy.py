"""Checker: ledger-event taxonomy + ``HEAT3D_*`` registry drift, over the
port.

The ledger's event vocabulary and the knob surface are contracts consumed
far from where they are produced: ``obs summary`` pattern-matches event
names, operators grep the docs for knobs, ``obs check --taxonomy`` audits
streams. This checker pins the three legs together through
:mod:`heat3d_tpu_torch.analysis.registry`:

- every ``.event("name")`` / ``.span("name")`` literal in the port and
  ``chip_smoke.py`` (plus registered wrapper calls like ``_event_once``
  and the ledger's internal ``_write(name, kind)``) must name a
  registered event, with the registered *kind* (point vs span) matching
  the emission form;
- every registered event must have a row in the port's taxonomy table
  (``heat3d_tpu_torch/docs/OBSERVABILITY.md``; the JAX package's
  ``docs/OBSERVABILITY.md`` is the reference's) — and registry entries
  nothing emits are flagged stale (``external`` entries, emitted by child
  code the AST cannot see, and ``REFERENCE_EVENTS``, which only the JAX
  package emits, are exempt from the emission check only);
- every ``HEAT3D_*`` token referenced in the port or ``chip_smoke.py``
  must be a registered name (an environment variable, or an ``nvcc``
  macro of the kernels' build), every registered name must be
  documented, and registered-but-unreferenced names are stale. Prefix
  references (``HEAT3D_BURN_*`` in prose) match any registered name that
  extends them.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from heat3d_tpu_torch.analysis import astutil
from heat3d_tpu_torch.analysis.findings import ERROR, WARNING, Finding
from heat3d_tpu_torch.analysis.registry import (
    ENV_VARS,
    EVENT_WRAPPERS,
    LEDGER_EVENTS,
    REFERENCE_EVENTS,
)

CHECKER = "ledger-taxonomy"

_ENV_TOKEN = re.compile(r"HEAT3D_[A-Z0-9_]+")
_DOCS = "heat3d_tpu_torch/docs/OBSERVABILITY.md"
_REGISTRY = "heat3d_tpu_torch/analysis/registry.py"


def _emissions(
    root: str, files: Sequence[str]
) -> List[Tuple[str, str, str, int]]:
    """(name, kind, relpath, line) for every literal event/span emission."""
    out: List[Tuple[str, str, str, int]] = []
    for path in files:
        tree = astutil.parse_file(path)
        if tree is None:
            continue
        relpath = astutil.rel(root, path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            m = astutil.method_name(node)
            if m in ("event", "span"):
                name = astutil.literal_str_arg(node, 0)
                if name is not None:
                    kind = "point" if m == "event" else "span"
                    out.append((name, kind, relpath, node.lineno))
            elif m in EVENT_WRAPPERS:
                name = astutil.literal_str_arg(node, 0)
                if name is not None:
                    out.append((name, "point", relpath, node.lineno))
            elif m == "_write":
                name = astutil.literal_str_arg(node, 0)
                kind = astutil.literal_str_arg(node, 1)
                if name is not None and kind in ("point", "span"):
                    out.append((name, kind, relpath, node.lineno))
    return out


def _env_tokens(
    root: str, files: Sequence[str]
) -> Dict[str, Tuple[str, int]]:
    """token -> first (relpath, line) reference, from the scanned code."""
    out: Dict[str, Tuple[str, int]] = {}
    for path in files:
        relpath = astutil.rel(root, path)
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for i, line in enumerate(lines, start=1):
            for m in _ENV_TOKEN.finditer(line):
                tok = m.group(0).rstrip("_")
                if tok == "HEAT3D" or tok in out:
                    continue
                out[tok] = (relpath, i)
    return out


def _docs_has_row(
    docs_text: str, name: str, kind: Optional[str] = None
) -> bool:
    """True when the docs carry a rendered taxonomy-table row for
    ``name`` (``| `name` | kind | ...``). Anchored to the backticked
    row start — a bare substring test would let `bench_row` ride on
    `bench_row_measure`'s row after its own was deleted — and, for
    events, the row's kind column must match the registry."""
    for line in docs_text.splitlines():
        if line.startswith(f"| `{name}` |"):
            if kind is None or f"| {kind} |" in line:
                return True
    return False


def check(
    root: str,
    files: Optional[Sequence[str]] = None,
    events_registry: Optional[Dict[str, Dict]] = None,
    env_registry: Optional[Dict[str, Dict]] = None,
    docs_path: str = _DOCS,
) -> List[Finding]:
    events_registry = (
        events_registry if events_registry is not None else LEDGER_EVENTS
    )
    env_registry = env_registry if env_registry is not None else ENV_VARS

    if files is None:
        code_files = [
            p
            for p in astutil.iter_py_files(root)
            # the analysis package and registry NAME events/knobs without
            # emitting or reading them; scanning them would count every
            # registry entry as used. The kernel tier is the exception: it
            # emits kernel_lint_* and reads its own knob, so it stays in
            # the scan.
            if os.sep + "analysis" + os.sep not in p
            or os.sep + os.path.join("analysis", "kernel") + os.sep in p
        ]
    else:
        code_files = list(files)

    findings: List[Finding] = []

    # ---- ledger events -----------------------------------------------------
    emitted: Dict[str, List[Tuple[str, str, int]]] = {}
    for name, kind, relpath, line in _emissions(root, code_files):
        emitted.setdefault(name, []).append((kind, relpath, line))
        reg = events_registry.get(name)
        if reg is None:
            findings.append(
                Finding(
                    checker=CHECKER,
                    severity=ERROR,
                    path=relpath,
                    line=line,
                    code="ANL401",
                    symbol=name,
                    message=(
                        f"ledger event '{name}' is emitted but not in the "
                        "canonical registry "
                        "(heat3d_tpu_torch/analysis/registry.LEDGER_EVENTS) — "
                        "register it and add its taxonomy row to "
                        f"{docs_path}"
                    ),
                )
            )
        elif reg.get("kind") != kind:
            findings.append(
                Finding(
                    checker=CHECKER,
                    severity=ERROR,
                    path=relpath,
                    line=line,
                    code="ANL402",
                    symbol=name,
                    message=(
                        f"ledger event '{name}' emitted as {kind} but "
                        f"registered as {reg.get('kind')} — obs summary's "
                        "span tables and the data lint key on the kind"
                    ),
                )
            )

    docs_file = os.path.join(root, docs_path)
    try:
        with open(docs_file) as f:
            docs_text = f.read()
    except OSError as e:
        # an unreadable docs file must not silently disable the whole
        # documentation leg (ANL404/412) — that's a finding, not a skip
        docs_text = None
        findings.append(
            Finding(
                checker=CHECKER,
                severity=ERROR,
                path=docs_path,
                line=0,
                code="ANL405",
                message=(
                    f"taxonomy docs file unreadable ({e}) — the "
                    "registered-must-be-documented checks cannot run"
                ),
            )
        )

    for name, reg in sorted(events_registry.items()):
        if name not in emitted and not reg.get("external") \
                and name not in REFERENCE_EVENTS:
            findings.append(
                Finding(
                    checker=CHECKER,
                    severity=WARNING,
                    path=_REGISTRY,
                    line=0,
                    code="ANL403",
                    symbol=name,
                    message=(
                        f"registered ledger event '{name}' is never "
                        "emitted by the port — stale registry entry (or "
                        "the emitter moved behind a dynamic name; mark it "
                        "external, or list it in REFERENCE_EVENTS when only "
                        "the JAX package emits it)"
                    ),
                )
            )
        if docs_text is not None and not _docs_has_row(
            docs_text, name, reg.get("kind")
        ):
            findings.append(
                Finding(
                    checker=CHECKER,
                    severity=ERROR,
                    path=docs_path,
                    line=0,
                    code="ANL404",
                    symbol=name,
                    message=(
                        f"registered ledger event '{name}' has no "
                        f"taxonomy-table row in {docs_path} with its "
                        f"registered kind ({reg.get('kind')}) — add/fix "
                        "the row"
                    ),
                )
            )

    # ---- env vars ----------------------------------------------------------
    referenced = _env_tokens(root, code_files)

    def _covers(tok: str) -> bool:
        return tok in env_registry or any(
            v.startswith(tok + "_") for v in env_registry
        )

    for tok, (relpath, line) in sorted(referenced.items()):
        if not _covers(tok):
            findings.append(
                Finding(
                    checker=CHECKER,
                    severity=ERROR,
                    path=relpath,
                    line=line,
                    code="ANL411",
                    symbol=tok,
                    message=(
                        f"HEAT3D name '{tok}' is referenced but not in the "
                        "canonical registry "
                        "(heat3d_tpu_torch/analysis/registry.ENV_VARS) — "
                        "register it with its kind and add its taxonomy "
                        f"row to {docs_path}"
                    ),
                )
            )
    for var in sorted(env_registry):
        if docs_text is not None and not _docs_has_row(docs_text, var):
            findings.append(
                Finding(
                    checker=CHECKER,
                    severity=ERROR,
                    path=docs_path,
                    line=0,
                    code="ANL412",
                    symbol=var,
                    message=(
                        f"registered name '{var}' has no "
                        f"taxonomy-table row in {docs_path} — add it"
                    ),
                )
            )
        if var not in referenced:
            findings.append(
                Finding(
                    checker=CHECKER,
                    severity=WARNING,
                    path=_REGISTRY,
                    line=0,
                    code="ANL413",
                    symbol=var,
                    message=(
                        f"registered name '{var}' is referenced nowhere "
                        "in the port or chip_smoke.py — stale registry "
                        "entry"
                    ),
                )
            )
    return findings

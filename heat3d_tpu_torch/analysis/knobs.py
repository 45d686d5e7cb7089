"""Checker: config-knob drift across the port's five surfaces that must
agree.

A performance knob is only real when five layers agree on it:
``SolverConfig`` carries it, the tuner's lattice searches it, the CLI
exposes it, the bench rows record it (so the regression gate and the
provenance lint can key on it), and the port's TUNING doc
(``heat3d_tpu_torch/docs/TUNING.md``) teaches it. This checker loads the
five surfaces LIVE (the real ``CONFIG_KNOBS``/``DEFAULT_KNOBS``/parser —
a registry copy would just be a sixth thing to drift) and cross-checks:

- ANL501: ``tune.cache.CONFIG_KNOBS`` (the canonical knob tuple — the
  cache entry schema) must all be ``SolverConfig`` fields;
- ANL502: every ``tune.space.DEFAULT_KNOBS`` key must be a config knob
  (or ``mesh``, the opt-in topology axis);
- ANL503: every config knob must be searched by the default lattice;
- ANL504: every config knob must have its ``--flag`` on the solver CLI
  (the bench CLI inherits that parser);
- ANL505: every config knob must be recorded on bench throughput rows
  (``bench/harness.py``);
- ANL506: every provenance route field the lint requires
  (``analysis.provenance.ROUTE_FIELDS``) must be recorded on rows;
- ANL507: every config knob must be documented in the port's TUNING doc.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set

from heat3d_tpu_torch.analysis import astutil
from heat3d_tpu_torch.analysis.findings import ERROR, Finding

CHECKER = "knob-drift"

_CACHE_PY = "heat3d_tpu_torch/tune/cache.py"
_SPACE_PY = "heat3d_tpu_torch/tune/space.py"
_CLI_PY = "heat3d_tpu_torch/cli.py"
_HARNESS_PY = "heat3d_tpu_torch/bench/harness.py"
_TUNING_MD = "heat3d_tpu_torch/docs/TUNING.md"


def _harness_row_keys(root: str, harness_path: str) -> Set[str]:
    """String keys of dict literals (plus string subscript-assignment
    targets, ``row["x"] = ...``) in the bench harness — the row field
    names. Deliberately NOT every string literal: a knob named in a
    docstring or log message must not count as 'recorded on rows'."""
    tree = astutil.parse_file(os.path.join(root, harness_path))
    if tree is None:
        return set()
    keys: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Dict):
            for k in n.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)
                ):
                    keys.add(t.slice.value)
    return keys


def check(
    root: str,
    knobs: Optional[Sequence[str]] = None,
    space_keys: Optional[Sequence[str]] = None,
    cli_flags: Optional[Sequence[str]] = None,
    row_strings: Optional[Set[str]] = None,
    route_fields: Optional[Sequence[str]] = None,
    tuning_doc: Optional[str] = None,
) -> List[Finding]:
    """All sources are injectable for fixture tests; by default the LIVE
    surfaces are loaded."""
    import dataclasses

    from heat3d_tpu_torch.core.config import SolverConfig

    if knobs is None:
        from heat3d_tpu_torch.tune.cache import CONFIG_KNOBS as knobs  # type: ignore[no-redef]
    if space_keys is None:
        from heat3d_tpu_torch.tune.space import DEFAULT_KNOBS

        space_keys = list(DEFAULT_KNOBS)
    if cli_flags is None:
        from heat3d_tpu_torch.cli import build_parser

        cli_flags = [
            s for a in build_parser()._actions for s in a.option_strings
        ]
    if row_strings is None:
        row_strings = _harness_row_keys(root, _HARNESS_PY)
    if route_fields is None:
        from heat3d_tpu_torch.analysis.provenance import ROUTE_FIELDS as route_fields  # type: ignore[no-redef]
    if tuning_doc is None:
        try:
            with open(os.path.join(root, _TUNING_MD)) as f:
                tuning_doc = f.read()
        except OSError:
            tuning_doc = ""

    cfg_fields = {f.name for f in dataclasses.fields(SolverConfig)}
    findings: List[Finding] = []

    def add(code: str, path: str, symbol: str, message: str) -> None:
        findings.append(
            Finding(
                checker=CHECKER,
                severity=ERROR,
                path=path,
                line=0,
                code=code,
                symbol=symbol,
                message=message,
            )
        )

    for k in knobs:
        if k not in cfg_fields:
            add(
                "ANL501", _CACHE_PY, k,
                f"CONFIG_KNOBS lists '{k}' but SolverConfig has no such "
                "field — the cache entry schema and the config surface "
                "disagree",
            )
    for k in space_keys:
        if k not in knobs and k != "mesh":
            add(
                "ANL502", _SPACE_PY, k,
                f"DEFAULT_KNOBS searches '{k}' which is not a config knob "
                "(tune.cache.CONFIG_KNOBS) — the tuner would measure a "
                "knob the cache cannot store or resolve",
            )
    for k in knobs:
        if k not in space_keys:
            add(
                "ANL503", _SPACE_PY, k,
                f"config knob '{k}' is absent from the default search "
                "lattice (DEFAULT_KNOBS) — auto resolution can serve a "
                "knob the search never measures",
            )
        flag = "--" + k.replace("_", "-")
        if flag not in cli_flags:
            add(
                "ANL504", _CLI_PY, k,
                f"config knob '{k}' has no CLI flag {flag} — a tuned "
                "winner cannot be applied from the command line "
                "(tune apply emits flag lines)",
            )
        if k not in row_strings:
            add(
                "ANL505", _HARNESS_PY, k,
                f"config knob '{k}' is not recorded on bench rows — the "
                "regression gate and sweep journals cannot key on it, so "
                "A/Bs of this knob are unprovenanced",
            )
        if tuning_doc and k not in tuning_doc:
            add(
                "ANL507", _TUNING_MD, k,
                f"config knob '{k}' is undocumented in {_TUNING_MD} — "
                "add it to the knob table",
            )
    for rf in route_fields:
        if rf not in row_strings:
            add(
                "ANL506", _HARNESS_PY, rf,
                f"provenance route field '{rf}' (required by "
                "check_provenance on throughput rows) is not recorded by "
                "the bench harness — every new row would fail the "
                "provenance lint",
            )
    return findings

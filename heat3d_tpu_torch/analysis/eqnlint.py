"""Checker: equation-registry drift across the port's surfaces that must
agree.

An equation family is only real when four layers agree on it: the
``heat3d_tpu_torch.eqn`` registry defines it, the solver CLI exposes it
(``--equation``), the port's EQUATIONS doc
(``heat3d_tpu_torch/docs/EQUATIONS.md``) teaches it (the family table),
and the port's tests (``tests/test_torch_*.py``) exercise it. The
knob-drift checker (ANL501-507) guards the tuner-knob pentagon the same
way; this one guards the family square — an undocumented or untested
family is a finding, not a feature. Live surfaces are loaded (the real
registry, the real parser), the docs leg is row-anchored like the
taxonomy checker's (``| `name` |`` — a deleted row cannot ride on a
longer name's row).

- ANL521: registry vs CLI ``--equation`` choices drift (either
  direction — a family the CLI cannot select, or a CLI choice the
  registry does not define);
- ANL522: registry vs the EQUATIONS doc's family-table drift (either
  direction);
- ANL523: a family without a manufactured-solution reference
  (``mms_rates``) — its convergence can never be certified;
- ANL524: a family no port test file ever names — registered and documented
  but unexercised.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Set

from heat3d_tpu_torch.analysis.findings import ERROR, Finding

CHECKER = "eqn-registry"

_EQN_INIT = "heat3d_tpu_torch/eqn/__init__.py"
_CLI_PY = "heat3d_tpu_torch/cli.py"
_EQN_MD = "heat3d_tpu_torch/docs/EQUATIONS.md"
_TESTS_DIR = "tests"
_TESTS_PREFIX = "test_torch_"


def _docs_families(doc_text: str) -> Set[str]:
    """Family names with a row in the docs table — anchored on the
    backticked row start (``| `name` |``), the ANL404 discipline."""
    out: Set[str] = set()
    for line in doc_text.splitlines():
        if line.startswith("| `"):
            name = line[3:].split("`", 1)[0]
            if name:
                out.add(name)
    return out


def _tests_text(root: str) -> str:
    chunks = []
    tdir = os.path.join(root, _TESTS_DIR)
    if os.path.isdir(tdir):
        for fn in sorted(os.listdir(tdir)):
            if fn.startswith(_TESTS_PREFIX) and fn.endswith(".py"):
                try:
                    with open(os.path.join(tdir, fn)) as f:
                        chunks.append(f.read())
                except OSError:
                    pass
    return "\n".join(chunks)


def check(
    root: str,
    families: Optional[Dict[str, object]] = None,
    cli_choices: Optional[Sequence[str]] = None,
    doc_text: Optional[str] = None,
    tests_text: Optional[str] = None,
) -> List[Finding]:
    """All sources injectable for fixture tests; by default the LIVE
    surfaces are loaded (the same posture as the knob-drift checker)."""
    if families is None:
        from heat3d_tpu_torch.eqn import FAMILIES as families  # type: ignore[no-redef]
    if cli_choices is None:
        from heat3d_tpu_torch.cli import build_parser

        cli_choices = []
        for a in build_parser()._actions:
            if "--equation" in a.option_strings:
                cli_choices = list(a.choices or [])
    if doc_text is None:
        try:
            with open(os.path.join(root, _EQN_MD)) as f:
                doc_text = f.read()
        except OSError:
            doc_text = ""
    if tests_text is None:
        tests_text = _tests_text(root)

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

    reg = set(families)
    cli = set(cli_choices)
    for name in sorted(reg - cli):
        add(
            "ANL521", _CLI_PY, name,
            f"equation family '{name}' is registered but not a CLI "
            "--equation choice — operators cannot select it "
            "(the choices must come from the live registry)",
        )
    for name in sorted(cli - reg):
        add(
            "ANL521", _CLI_PY, name,
            f"CLI --equation choice '{name}' is not a registered family "
            "— selecting it fails at config validation",
        )

    documented = _docs_families(doc_text)
    for name in sorted(reg - documented):
        add(
            "ANL522", _EQN_MD, name,
            f"equation family '{name}' has no row in the "
            f"{_EQN_MD} family table — an undocumented family "
            "is invisible to operators",
        )
    for name in sorted(documented - reg):
        add(
            "ANL522", _EQN_MD, name,
            f"{_EQN_MD} documents family '{name}' which the "
            "registry does not define — stale docs row",
        )

    for name in sorted(reg):
        fam = families[name]
        if not callable(getattr(fam, "mms_rates", None)):
            add(
                "ANL523", _EQN_INIT, name,
                f"equation family '{name}' carries no manufactured-"
                "solution reference (mms_rates) — its convergence order "
                "can never be certified against an analytic solution",
            )
        if f'"{name}"' not in tests_text and f"'{name}'" not in tests_text:
            add(
                "ANL524", _EQN_INIT, name,
                f"equation family '{name}' is never named by any test "
                "file — registered and documented but unexercised "
                "(add an MMS/golden test; tests/test_torch_eqn.py is the "
                "home)",
            )
    return findings

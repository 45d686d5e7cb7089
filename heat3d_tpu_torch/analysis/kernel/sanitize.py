"""The sanitizer families: every case under ``compute-sanitizer``.

Value parity (kernel = plain version, bitwise) cannot see an out-of-bounds
store that lands in memory nobody reads, a shared-memory read that wins a
race by luck, a barrier some threads skip, or a read of memory nobody
wrote. Four tools of ``compute-sanitizer`` can:

- ``kernel-memcheck`` (``--tool memcheck``, ANL1001): out-of-bounds and
  misaligned global, shared and local accesses;
- ``kernel-sync`` (``--tool synccheck``, ANL1002): barrier misuse;
- ``kernel-init`` (``--tool initcheck``, ANL1011): reads of device memory
  no one wrote;
- ``kernel-races`` (``--tool racecheck``, ANL1012; its warnings ANL1013):
  shared-memory hazards, the counterpart of the JAX tier's ring-slot
  happens-before proof. The seeded racy kernel (``seeded.cu``) runs in the
  same child and must be flagged (ANL1014 when it is not: the tool is
  blind, so its clean verdicts prove nothing).

Each tool runs one child over the judged cases,
``compute-sanitizer --tool T --error-exitcode 1 python -m
heat3d_tpu_torch.analysis.kernel.cases KEY ...``, from the kernels already
built (``_build.build_all`` first). The child prints a marker line before
and after each case, so each report falls to its case. A case that
crashes or hangs under the tool is restarted past: its verdict is
"not certified" (ANL1005, a warning, with the tool's last words), never
dropped. The four tools run at once. Without a CUDA device, without the
tool, or when the tool refuses the card ("Device not supported": the
first child says so, and no further child runs), each family yields one
ANL1005 warning with the tool's words and every case reads "not
certified" — never a clean verdict.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from heat3d_tpu_torch.analysis.findings import ERROR, WARNING, Finding

_PATH = "heat3d_tpu_torch/analysis/kernel/sanitize.py"
# family -> (tool, error code)
TOOLS = {
    "kernel-memcheck": ("memcheck", "ANL1001"),
    "kernel-races": ("racecheck", "ANL1012"),
    "kernel-sync": ("synccheck", "ANL1002"),
    "kernel-init": ("initcheck", "ANL1011"),
}
_PREFIX = "========= "
# a report's headline (its further lines are indented under it)
_ERROR_HEAD = re.compile(
    r"^(Invalid|Error|Barrier error|Uninitialized|Out-of-range|Misaligned|Address|"
    r"Malloc|Illegal|Race reported|Potential (RAW|WAR|WAW)|Hazard|Divergent|Unused)")
_WARNING_HEAD = re.compile(r"^Warning")
# the tool could not check: matched before the error heads ("Error: Device
# not supported" is the tool refusing the card, not a fault of a kernel)
_UNCERTIFIED_HEAD = re.compile(
    r"(not supported|Internal Sanitizer Error|process didn't terminate|Unable to|"
    r"Target application terminated)", re.I)
# the tool refuses the device itself: no case can be certified by it
_DEVICE_REFUSED = re.compile(r"Device not supported", re.I)
# a racecheck report of a hazard (the seeded kernel must raise one)
_RACE = re.compile(r"race|hazard", re.I)


def sanitizer_path() -> Optional[str]:
    """``compute-sanitizer``: ``$CUDA_HOME/bin``, ``PATH``, then
    ``/usr/local/cuda/bin``; None when the toolkit lacks it."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "compute-sanitizer"))
    which = shutil.which("compute-sanitizer")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/compute-sanitizer")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def child_timeout_s() -> float:
    return float(os.environ.get("HEAT3D_KERNEL_LINT_TIMEOUT_S", "600"))


class CaseReport:
    """What one child said of one case: its end status (ok, raised ...,
    or None when the child died in it) and the tool's report lines."""

    def __init__(self):
        self.status: Optional[str] = None
        self.errors: List[str] = []
        self.warnings: List[str] = []
        self.uncertified: List[str] = []
        self.lines: List[str] = []


def parse_report(text: str) -> Tuple[Dict[str, CaseReport], CaseReport]:
    """Per case (in the order the child began them) its report, and the
    report of what fell outside every case (start-up, exit)."""
    from heat3d_tpu_torch.analysis.kernel.cases import BEGIN, END

    cases: Dict[str, CaseReport] = {}
    outside = CaseReport()
    cur = outside
    for line in text.splitlines():
        if line.startswith(BEGIN + " "):
            cur = cases.setdefault(line[len(BEGIN) + 1:].strip(), CaseReport())
            continue
        if line.startswith(END + " "):
            rest = line[len(END) + 1:].split(" ", 1)
            rep = cases.setdefault(rest[0], CaseReport())
            rep.status = rest[1] if len(rest) > 1 else "ok"
            cur = outside
            continue
        if not line.startswith(_PREFIX):
            continue
        body = line[len(_PREFIX):]
        cur.lines.append(body)
        if body.startswith(" "):
            continue  # a further line of the report above
        if _UNCERTIFIED_HEAD.search(body):
            cur.uncertified.append(body.strip())
        elif _WARNING_HEAD.match(body):
            cur.warnings.append(body.strip())
        elif _ERROR_HEAD.match(body):
            cur.errors.append(body.strip())
    return cases, outside


def _tail(text: str, n: int = 3) -> str:
    lines = [ln.strip() for ln in text.strip().splitlines() if ln.strip()]
    return " | ".join(lines[-n:])[:400]


def run_tool(tool: str, keys: Sequence[str], root: str, exe: str,
             timeout_s: Optional[float] = None) -> Tuple[Dict[str, CaseReport], Dict]:
    """Every case of ``keys`` under ``tool``, one child at a time, each
    restarted past a case it died in, within ``timeout_s`` in all. Returns
    the per-case reports and the run's facts (children, seconds, the
    tool's last words outside cases, and ``refused``: its words when it
    refuses the card)."""
    timeout_s = child_timeout_s() if timeout_s is None else timeout_s
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["HEAT3D_KERNEL_LINT_TIMEOUT_S"] = str(timeout_s)
    reports: Dict[str, CaseReport] = {}
    facts = {"children": 0, "seconds": 0.0, "outside": [], "refused": None}
    remaining = list(keys)
    t0 = time.perf_counter()
    while remaining:
        if time.perf_counter() - t0 > timeout_s:
            for k in remaining:
                reports.setdefault(k, CaseReport()).status = (
                    f"the tool's budget of {timeout_s:.0f} s ran out before the case")
            break
        cmd = [exe, "--tool", tool, "--error-exitcode", "1", "--report-api-errors", "no",
               "--print-limit", "200", sys.executable, "-m",
               "heat3d_tpu_torch.analysis.kernel.cases", *remaining]
        facts["children"] += 1
        try:
            proc = subprocess.run(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, timeout=timeout_s)
            text, how = proc.stdout, f"exit {proc.returncode}"
        except subprocess.TimeoutExpired as e:
            text = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
            how = f"no end within {timeout_s:.0f} s"
        got, outside = parse_report(text)
        facts["outside"].extend(outside.errors + outside.uncertified)
        refused = [ln for rep in [outside, *got.values()] for ln in rep.uncertified
                   if _DEVICE_REFUSED.search(ln)]
        if refused:
            # the tool refuses the card: every case is "not certified" for
            # the same reason, and no further child can change that
            facts["refused"] = refused[0]
            for k in remaining:
                rep = reports.setdefault(k, got.get(k, CaseReport()))
                rep.status = f"not certified: {tool}: {refused[0]}"
                rep.uncertified = [refused[0]]
            break
        began = [k for k in remaining if k in got]
        if not began:
            for k in remaining:
                rep = reports.setdefault(k, CaseReport())
                rep.status = f"the child ran no case ({how}): {_tail(text)}"
            break
        for k in began:
            reports[k] = got[k]
        last = began[-1]
        if got[last].status is None:
            got[last].status = f"died in the case ({how}): {_tail(text)}"
        remaining = remaining[remaining.index(last) + 1:]
    facts["seconds"] = time.perf_counter() - t0
    return reports, facts


def uncertified(name: str, symbol: str, message: str) -> Finding:
    return Finding(checker=name, severity=WARNING, path=_PATH, line=0, code="ANL1005",
                   symbol=symbol, message=f"not certified: {message}")


def check(names: Sequence[str], cases: Sequence, root: str, device, report: Dict,
          seeded: bool = True) -> List[Finding]:
    """The named sanitizer families over ``cases`` (their tools at once);
    ``seeded`` runs the seeded racy kernel in the racecheck child."""
    import torch

    from heat3d_tpu_torch.analysis.kernel.cases import SEEDED

    verdicts = report.setdefault("verdicts", {})
    findings: List[Finding] = []
    exe = sanitizer_path()
    report["sanitizer"] = exe
    why = None
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        why = f"no CUDA device ({device})"
    elif exe is None:
        why = ("the CUDA toolkit has no compute-sanitizer ($CUDA_HOME/bin, PATH, "
               "/usr/local/cuda/bin)")
    if why is not None:
        for name in names:
            verdicts[name] = {c.key: "not certified" for c in cases}
            findings.append(uncertified(name, f"{name}|device", why))
        return findings
    from heat3d_tpu_torch.ops import _build

    _build.build_all()
    _build.build_all(["seeded_race"])

    def one(name):
        keys = [c.key for c in cases]
        if name == "kernel-races" and seeded:
            keys = [SEEDED] + keys
        return name, run_tool(TOOLS[name][0], keys, root, exe)

    with ThreadPoolExecutor(max(1, len(names))) as pool:
        results = list(pool.map(one, names))
    seconds = report.setdefault("seconds", {})
    for name, (reports, facts) in results:
        tool, code = TOOLS[name]
        seconds[name] = facts["seconds"]
        report.setdefault("children", {})[name] = facts["children"]
        mine = verdicts.setdefault(name, {})
        if facts["refused"] is not None:
            report.setdefault("refused", {})[name] = facts["refused"]
            for c in cases:
                mine[c.key] = "not certified"
            if name == "kernel-races" and seeded:
                report["seeded"] = {"flagged": False, "certified": False,
                                    "status": reports[SEEDED].status}
            findings.append(uncertified(
                name, f"{name}|refused",
                f"{tool} refuses this device ({exe}: {facts['refused']}); none of the "
                f"{len(cases)} cases is certified by it"))
            continue
        if name == "kernel-races" and seeded:
            rep = reports.get(SEEDED, CaseReport())
            flagged = any(_RACE.search(ln) for ln in rep.errors + rep.warnings)
            report["seeded"] = {"flagged": flagged, "certified": True,
                                "report": (rep.errors + rep.warnings)[:3],
                                "status": rep.status}
            if not flagged:
                findings.append(Finding(
                    checker=name, severity=ERROR, path=_PATH, line=0, code="ANL1014",
                    symbol="seeded-race|ANL1014",
                    message=("racecheck did not flag the seeded racy kernel "
                             "(analysis/kernel/seeded.cu: a shared read before the "
                             f"barrier; child status {rep.status!r}) — its clean "
                             "verdicts prove nothing")))
        for c in cases:
            rep = reports.get(c.key)
            if rep is None:
                mine[c.key] = "not certified"
                findings.append(uncertified(name, f"{c.key}|ANL1005",
                                             f"{c.key} under {tool}: no child reached it"))
                continue
            if rep.errors:
                mine[c.key] = "error"
                findings.append(Finding(
                    checker=name, severity=ERROR, path=_PATH, line=0, code=code,
                    symbol=f"{c.key}|{code}",
                    message=(f"{c.key} (row {c.row}, {c.wrapper}) under {tool}: "
                             f"{len(rep.errors)} report(s): {' | '.join(rep.errors[:3])}")))
            elif rep.status != "ok" or rep.uncertified:
                mine[c.key] = "not certified"
                findings.append(uncertified(
                    name, f"{c.key}|ANL1005",
                    f"{c.key} (row {c.row}, {c.wrapper}) under {tool}: "
                    f"{'; '.join(rep.uncertified[:2]) or rep.status}"))
            elif rep.warnings:
                mine[c.key] = "warning"
                findings.append(Finding(
                    checker=name, severity=WARNING, path=_PATH, line=0, code="ANL1013",
                    symbol=f"{c.key}|ANL1013",
                    message=(f"{c.key} (row {c.row}, {c.wrapper}) under {tool}: "
                             f"{' | '.join(rep.warnings[:3])}")))
            else:
                mine[c.key] = "clean"
        if facts["outside"]:
            findings.append(uncertified(
                name, f"{name}|outside",
                f"{tool} reported outside every case: {' | '.join(facts['outside'][:3])}"))
    return findings

"""Checker: fail-soft enforcement for the port's obs/ telemetry surface.

The design invariant — "telemetry never kills the run it observes"
(heat3d_tpu_torch/docs/OBSERVABILITY.md, Failure posture) — was stated and hand-enforced:
every ledger write, metrics export, and profiler bracket is supposed to
swallow *environmental* failures (file IO, serialization) instead of
propagating them into the instrumented run. Nothing checked it; a PR
adding one unguarded ``open()`` three calls deep silently converts every
instrumented caller into a crash site the next time a disk fills.

This checker enforces it mechanically. For every function in the
:data:`~heat3d_tpu_torch.analysis.registry.FAIL_SOFT_CONTRACT` surface it
computes, over the intra-``obs/`` call graph, the set of environmental
exception classes that can escape to the caller:

- **risky ops**: ``open``/``os.makedirs``/``os.replace``/``.write``/
  ``.flush``/``.close``/... raise ``OSError``; ``json.dumps``/``dump``
  raise ``TypeError``/``ValueError``; ``json.loads``/``load`` raise
  ``ValueError``.
- **guards**: an ancestor ``try`` whose handlers catch the class or a
  superclass (``Exception``/``BaseException``/bare ``except``) absorbs
  the risk; so does a guard at the *call site* of a helper whose own
  body leaks.
- **propagation**: unguarded risk flows caller-ward through resolvable
  calls (module functions, ``self.`` methods, ``ClassName(...)`` ->
  ``__init__``, names imported from the contract modules).

Deliberate contract raises (``Counter.inc`` rejecting negative
increments) are out of scope: those are caller bugs, not environment.
Unresolvable calls (stdlib, torch) contribute no risk — the checker is a
tripwire for the obs package's own IO, not a theorem prover; its misses
are documented in heat3d_tpu_torch/docs/ANALYSIS.md.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from heat3d_tpu_torch.analysis import astutil
from heat3d_tpu_torch.analysis.findings import ERROR, Finding
from heat3d_tpu_torch.analysis.registry import FAIL_SOFT_CONTRACT

CHECKER = "fail-soft"

# risky-op table: matcher -> exception classes raised
_OS_CALLS = {
    "open",
    "os.makedirs",
    "os.replace",
    "os.rename",
    "os.remove",
    "os.unlink",
    "os.fsync",
    "os.path.getmtime",
}
# file-handle method calls count as IO only on receivers that look like
# file handles (`f`, `self._f`, ...) — `ledger.close()` is not file IO,
# and its own leaks are covered by the contract on `Ledger.close` itself
_OS_METHOD_TAILS = {"write", "flush", "close", "read", "readlines"}
_FILE_RECEIVERS = {"f", "_f", "fh", "fp", "file", "tmp", "out"}
_JSON_DUMP = {"json.dumps", "json.dump"}
_JSON_LOAD = {"json.loads", "json.load"}

# exception-class subsumption for guard matching
_SUPERS: Dict[str, Set[str]] = {
    "OSError": {"OSError", "IOError", "EnvironmentError", "Exception", "BaseException", ""},
    "ValueError": {"ValueError", "Exception", "BaseException", ""},
    "TypeError": {"TypeError", "Exception", "BaseException", ""},
}


def _file_method(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr not in _OS_METHOD_TAILS:
        return False
    recv = astutil.dotted_name(call.func.value)
    return recv is not None and recv.rsplit(".", 1)[-1] in _FILE_RECEIVERS


def _risks_of_call(call: ast.Call) -> Set[str]:
    name = astutil.call_name(call)
    if name in _OS_CALLS or _file_method(call):
        return {"OSError"}
    if name in _JSON_DUMP:
        return {"TypeError", "ValueError"}
    if name in _JSON_LOAD:
        return {"ValueError"}
    return set()


def _unguarded(call: ast.Call, risks: Set[str]) -> Set[str]:
    """The subset of ``risks`` not absorbed by any ancestor try-handler."""
    handler_sets = astutil.guarding_handlers(call)
    out = set()
    for r in risks:
        caught = any(
            any(h.rsplit(".", 1)[-1] in _SUPERS[r] for h in handlers)
            for handlers in handler_sets
        )
        if not caught:
            out.add(r)
    return out


class _Module:
    def __init__(self, relpath: str, tree: ast.Module):
        self.relpath = relpath
        self.tree = tree
        # qualname -> FunctionDef (methods as Class.method)
        self.functions: Dict[str, ast.AST] = {}
        # imported-name -> (module relpath hint, qualname) for
        # `from heat3d_tpu_torch.obs.X import f` style imports
        self.imports: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[astutil.qualname(node)] = node
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )


def _resolve_call(
    call: ast.Call,
    mod: _Module,
    enclosing_class: Optional[str],
    all_functions: Dict[Tuple[str, str], ast.AST],
    module_of: Dict[str, str],
) -> Optional[Tuple[str, str]]:
    """(module relpath, qualname) of the callee when it is one of ours."""
    name = astutil.call_name(call)
    if name is None:
        return None
    # self.method() -> same class
    if name.startswith("self.") and enclosing_class:
        q = f"{enclosing_class}.{name[len('self.'):]}"
        if (mod.relpath, q) in all_functions:
            return (mod.relpath, q)
        return None
    # plain name: same-module function, ClassName() -> __init__, or import
    if "." not in name:
        if (mod.relpath, name) in all_functions:
            return (mod.relpath, name)
        if (mod.relpath, f"{name}.__init__") in all_functions:
            return (mod.relpath, f"{name}.__init__")
        target = mod.imports.get(name)
        if target:
            dotted_mod, _, func = target.rpartition(".")
            rel = module_of.get(dotted_mod)
            if rel and (rel, func) in all_functions:
                return (rel, func)
            if rel and (rel, f"{func}.__init__") in all_functions:
                return (rel, f"{func}.__init__")
        return None
    # module-qualified: `ledger.activate(...)` etc.
    head, _, func = name.rpartition(".")
    target = mod.imports.get(head)
    if target:
        rel = module_of.get(target)
        if rel and (rel, func) in all_functions:
            return (rel, func)
    return None


def check(
    root: str,
    contract: Optional[Dict[str, tuple]] = None,
    files: Optional[Sequence[str]] = None,
) -> List[Finding]:
    contract = contract if contract is not None else FAIL_SOFT_CONTRACT
    paths = (
        list(files)
        if files is not None
        else [os.path.join(root, relp) for relp in contract]
    )
    modules: Dict[str, _Module] = {}
    for p in paths:
        tree = astutil.parse_file(p)
        if tree is None:
            continue
        relp = astutil.rel(root, p)
        modules[relp] = _Module(relp, tree)

    all_functions: Dict[Tuple[str, str], ast.AST] = {
        (relp, q): fn
        for relp, mod in modules.items()
        for q, fn in mod.functions.items()
    }
    # dotted module name -> relpath ("heat3d_tpu_torch.obs.ledger" -> ".../ledger.py")
    module_of = {
        relp[:-3].replace(os.sep, "."): relp for relp in modules
    }

    # escape[(mod, qual)] = {exc: (witness_relpath, line, description)}
    escape: Dict[Tuple[str, str], Dict[str, Tuple[str, int, str]]] = {
        key: {} for key in all_functions
    }

    def _enclosing_class(fn: ast.AST) -> Optional[str]:
        q = astutil.qualname(fn)
        return q.rsplit(".", 1)[0] if "." in q else None

    # seed: direct unguarded risky ops
    for (relp, qual), fn in all_functions.items():
        for call in astutil.calls_in(fn):
            risks = _risks_of_call(call)
            if not risks:
                continue
            for exc in _unguarded(call, risks):
                escape[(relp, qual)].setdefault(
                    exc,
                    (relp, call.lineno, f"unguarded `{ast.unparse(call)[:60]}`"),
                )

    # propagate through resolvable calls until fixpoint
    changed = True
    while changed:
        changed = False
        for (relp, qual), fn in all_functions.items():
            mod = modules[relp]
            cls = _enclosing_class(fn)
            for call in astutil.calls_in(fn):
                callee = _resolve_call(call, mod, cls, all_functions, module_of)
                if callee is None or callee == (relp, qual):
                    continue
                for exc, (wp, wl, wd) in escape[callee].items():
                    if exc in escape[(relp, qual)]:
                        continue
                    if exc in _unguarded(call, {exc}):
                        escape[(relp, qual)][exc] = (
                            wp,
                            wl,
                            f"{wd} via {callee[1]} (called at line {call.lineno})",
                        )
                        changed = True

    findings: List[Finding] = []
    for relp, quals in contract.items():
        mod = modules.get(relp)
        for qual in quals:
            if mod is None or qual not in mod.functions:
                findings.append(
                    Finding(
                        checker=CHECKER,
                        severity=ERROR,
                        path=relp,
                        line=0,
                        code="ANL202",
                        symbol=qual,
                        message=(
                            f"fail-soft contract names '{qual}' but it does "
                            "not exist here — update the contract in "
                            "analysis/registry.py alongside the refactor"
                        ),
                    )
                )
                continue
            esc = escape[(relp, qual)]
            if not esc:
                continue
            details = "; ".join(
                f"{exc} from {wd} at {wp}:{wl}"
                for exc, (wp, wl, wd) in sorted(esc.items())
            )
            findings.append(
                Finding(
                    checker=CHECKER,
                    severity=ERROR,
                    path=relp,
                    line=mod.functions[qual].lineno,
                    code="ANL201",
                    symbol=qual,
                    message=(
                        f"public telemetry function '{qual}' can propagate "
                        f"{details} — the obs fail-soft invariant "
                        "(heat3d_tpu_torch/docs/OBSERVABILITY.md, Failure posture) "
                        "requires "
                        "environmental failures to be swallowed, not raised "
                        "into the instrumented run"
                    ),
                )
            )
    return findings

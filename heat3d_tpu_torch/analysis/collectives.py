"""Checker: collective-divergence — the deadlock-by-construction hazard.

The MPI ancestry of this codebase makes one defect class fatal in a way
no unit test can catch: a collective that *some* ranks execute and others
skip. Across processes that is not a failing test — it is a hung job,
each rank parked in a ``torch.distributed`` call (or a device-side wait on
a peer's word) that its peers never enter. The classic way to write one is
a Python-level conditional around a collective whose truth value differs
across ranks:

- **process-dependent** (``if distributed.process_index() == 0:``,
  ``dist.get_rank()``, ``is_coordinator()``, ``HEAT3D_PROCESS_ID``): each
  rank evaluates its own guard, so the collective runs on some ranks only —
  an ``MPI_Isend`` with no matching ``MPI_Irecv``.
- **device-dependent** (``Shard.slot``/``Shard.process``,
  ``torch.cuda.current_device()``): a value that differs with the card or
  the owning rank steering whether a collective runs.
- **data-dependent** (``if float(u.max()) > t:``, ``.item()``,
  ``bool(t)``, ``.tolist()``): tensor data read back to the host steering
  the branch; ranks holding different shards take different branches.

The collectives are ``torch.distributed``'s (``barrier``,
``all_gather_object``, ``broadcast_object_list``, ``all_reduce``,
``batch_isend_irecv``, ``send``/``recv``/``isend``/``irecv``, ...), the
port's wrappers in ``parallel/distributed.py``, ``ops/peer.py``'s
``signal``/``wait``, the wire's round methods (``parallel/wire.py``) and
the DMA and fused launches whose receivers may sit on another rank. Calls
to *collective-bearing* functions count too: a call-graph fixpoint over
the scanned files, so wrapping a collective two helpers deep hides
nothing. Calls resolve through each module's own definitions and imports;
a method call on a receiver of unknown type reaches every scanned method
of that name (deliberately conservative); calls into modules that are not
scanned (the standard library, torch, numpy) reach nothing. Uniform guards — static
config flags, ``periodic``, ``process_count()`` (the world size is the
same on every rank), mesh sizes — are not flagged.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from heat3d_tpu_torch.analysis import astutil
from heat3d_tpu_torch.analysis.findings import ERROR, Finding

CHECKER = "collective-divergence"

# collectives recognised by the called name's tail, whatever the receiver:
# torch.distributed's own, the port's wrappers (parallel/distributed.py),
# the wire's handshake, and the kernel launches that store into (or wait
# on) shards another rank may own
COLLECTIVE_CALLS = {
    "barrier",
    "all_gather_object",
    "broadcast_object_list",
    "broadcast_object",
    "all_reduce",
    "all_gather",
    "all_gather_into_tensor",
    "reduce_scatter",
    "all_to_all",
    "batch_isend_irecv",
    "isend",
    "irecv",
    "exchange_axis_dma",
    "push_link_dma",
    "apply_step_fused_dma",
    "apply_superstep_fused_dma",
    "apply_step_fused_rdma",
    "apply_superstep_fused_rdma",
}
# collectives recognised by (receiver tail, method): names too common to
# match alone (a file's ``flush``, a stream's ``wait``)
QUALIFIED_COLLECTIVES = {
    ("dist", "send"), ("dist", "recv"), ("dist", "broadcast"),
    ("dist", "reduce"), ("dist", "gather"), ("dist", "scatter"),
    ("distributed", "send"), ("distributed", "recv"),
    ("distributed", "broadcast"),
    ("peer", "signal"), ("peer", "wait"),
    ("wire", "flush"), ("wire", "begin"), ("wires", "connect"),
    ("wire", "connect"),
}

# the rank's identity: different VALUES on different ranks
PROCESS_DIVERGENT_CALLS = {"process_index", "is_coordinator", "get_rank", "get_node_local_rank"}
PROCESS_DIVERGENT_STRINGS = {"HEAT3D_PROCESS_ID", "RANK", "LOCAL_RANK"}

# the card or the owning rank of a shard
DEVICE_DIVERGENT_CALLS = {"current_device"}
DEVICE_DIVERGENT_ATTRS = {"slot", "process"}

# host materialization of tensor data: float()/int()/bool() over a
# torch-derived value, and .item() / .tolist()
_MATERIALIZERS = {"float", "int", "bool"}
_READBACKS = {"item", "tolist"}
_ARRAY_MODULES = ("torch",)


def _tail(name: Optional[str]) -> Optional[str]:
    return name.rsplit(".", 1)[-1] if name else None


def _receiver_tail(call: ast.Call) -> Optional[str]:
    """The last name of a method call's receiver (``self.wire.flush()`` ->
    ``wire``; ``_dist().barrier()`` -> ``_dist``)."""
    if not isinstance(call.func, ast.Attribute):
        return None
    recv = call.func.value
    if isinstance(recv, ast.Call):
        recv = recv.func
    name = astutil.dotted_name(recv)
    return _tail(name)


def _collective(call: ast.Call) -> bool:
    m = astutil.method_name(call)
    if m in COLLECTIVE_CALLS:
        return True
    recv = _receiver_tail(call)
    if recv == "_dist":
        recv = "dist"
    return (recv, m) in QUALIFIED_COLLECTIVES


# torch calls that make no tensor: their values are the same on every rank
_NON_TENSOR = {"device", "dtype", "Size", "finfo", "iinfo", "get_default_dtype",
               "is_tensor", "is_floating_point", "Generator", "Stream", "Event"}


def _is_array_call(call: ast.Call) -> bool:
    dn = astutil.call_name(call) or ""
    if dn.startswith(("torch.cuda.", "torch.distributed.")) or _tail(dn) in _NON_TENSOR:
        return False
    return any(dn.startswith(m + ".") for m in _ARRAY_MODULES)


def _process_witness(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and astutil.method_name(n) in PROCESS_DIVERGENT_CALLS:
            return True
        if isinstance(n, ast.Constant) and n.value in PROCESS_DIVERGENT_STRINGS:
            return True
    return False


def _device_witness(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and astutil.method_name(n) in DEVICE_DIVERGENT_CALLS:
            return True
        if isinstance(n, ast.Attribute) and n.attr in DEVICE_DIVERGENT_ATTRS \
                and isinstance(n.ctx, ast.Load):
            return True
    return False


def _collect_taint(func: ast.AST) -> Tuple[Set[str], Set[str], Set[str]]:
    """(process_tainted, device_tainted, data_tainted) local names in
    ``func``: simple one-level flow from ``x = <divergent expr>`` /
    ``x = torch.<op>(...)`` assignments."""
    process: Set[str] = set()
    device: Set[str] = set()
    data: Set[str] = set()
    for node in ast.walk(func):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not targets:
            continue
        if _process_witness(node.value):
            process.update(targets)
        elif _device_witness(node.value):
            device.update(targets)
        elif isinstance(node.value, ast.Call) and _is_array_call(node.value):
            data.update(targets)
    return process, device, data


def _classify_test(
    test: ast.AST,
    process_taint: Set[str],
    device_taint: Set[str],
    data_taint: Set[str],
) -> Optional[Tuple[str, str, str]]:
    """(kind, code, witness) when the conditional can diverge across
    ranks, else None."""
    if _process_witness(test):
        return ("process-dependent", "ANL101", ast.unparse(test))
    if _device_witness(test):
        return ("device-dependent", "ANL102", ast.unparse(test))
    for call in astutil.calls_in(test):
        tail = _tail(astutil.call_name(call))
        if astutil.method_name(call) in _READBACKS and isinstance(call.func, ast.Attribute):
            return ("data-dependent", "ANL103", ast.unparse(test))
        if tail in _MATERIALIZERS and isinstance(call.func, ast.Name):
            inner = call.args[0] if call.args else call.func
            if set(astutil.names_in(inner)) & data_taint or any(
                _is_array_call(c) for c in astutil.calls_in(inner)
            ):
                return ("data-dependent", "ANL103", ast.unparse(test))
    names = set(astutil.names_in(test))
    if names & process_taint:
        return ("process-dependent", "ANL101", ast.unparse(test))
    if names & device_taint:
        return ("device-dependent", "ANL102", ast.unparse(test))
    if names & data_taint:
        return ("data-dependent", "ANL103", ast.unparse(test))
    return None


class _Scope:
    """One scanned module: its dotted name, top-level functions, classes
    and methods, and what its imports bind."""

    def __init__(self, path: str, dotted: str, tree: ast.Module):
        self.path = path
        self.dotted = dotted
        self.functions: Dict[str, ast.AST] = {}  # qualname -> def
        self.classes: Set[str] = set()
        self.modules: Dict[str, str] = {}  # alias -> dotted module
        self.names: Dict[str, str] = {}  # alias -> dotted module.name
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[astutil.qualname(node)] = node
            elif isinstance(node, ast.ClassDef):
                self.classes.add(node.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.modules[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    self.names[a.asname or a.name] = f"{node.module}.{a.name}"


def _dotted_module(root: str, path: str) -> str:
    rel = astutil.rel(root, path)
    rel = rel[:-3] if rel.endswith(".py") else rel
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


_Key = Tuple[str, str]  # (module path, qualname)


def _callees(call: ast.Call, scope: _Scope, cls: Optional[str],
             by_dotted: Dict[str, _Scope], methods: Dict[str, List[_Key]]) -> List[_Key]:
    """The scanned functions a call may reach: module functions and
    constructors resolved through the module's own definitions and
    imports; ``self.m()`` to the enclosing class's method; any other
    receiver's ``.m()`` to every scanned method named ``m`` (the receiver's
    type is unknown: deliberately conservative). Calls into modules that
    are not scanned (the standard library, torch, numpy) reach nothing."""
    func = call.func

    def in_module(mod: _Scope, name: str) -> List[_Key]:
        if name in mod.functions:
            return [(mod.path, name)]
        if name in mod.classes and f"{name}.__init__" in mod.functions:
            return [(mod.path, f"{name}.__init__")]
        return []

    if isinstance(func, ast.Name):
        got = in_module(scope, func.id)
        if got:
            return got
        target = scope.names.get(func.id)
        if target:
            modname, _, name = target.rpartition(".")
            mod = by_dotted.get(modname)
            return in_module(mod, name) if mod is not None else []
        return []
    if not isinstance(func, ast.Attribute):
        return []
    head = astutil.dotted_name(func.value)
    if head == "self" and cls is not None:
        q = f"{cls}.{func.attr}"
        if q in scope.functions:
            return [(scope.path, q)]
    if head is not None and head != "self":
        first = head.split(".")[0]
        modname = None
        if first in scope.modules:
            modname = ".".join([scope.modules[first]] + head.split(".")[1:])
        elif first in scope.names:
            modname = ".".join([scope.names[first]] + head.split(".")[1:])
        if modname is not None:
            mod = by_dotted.get(modname)
            # an imported module that is not scanned reaches nothing; an
            # imported class or object falls through to the methods
            if mod is not None:
                return in_module(mod, func.attr)
            if not any(d.split(".")[0] == modname.split(".")[0] for d in by_dotted):
                return []
    return methods.get(func.attr, [])


def _collective_bearing(root: str, trees: Dict[str, ast.Module]):
    """(bearing, scopes, by_dotted, methods): ``bearing`` maps every
    scanned function that transitively contains a direct collective call
    to the chain that shows it (a call-graph fixpoint over
    :func:`_callees`); the rest is the resolution context."""
    scopes = {p: _Scope(p, _dotted_module(root, p), t) for p, t in trees.items()}
    by_dotted = {s.dotted: s for s in scopes.values()}
    methods: Dict[str, List[_Key]] = {}
    for s in scopes.values():
        for q in s.functions:
            if "." in q and q.rsplit(".", 1)[0] in s.classes:
                methods.setdefault(q.rsplit(".", 1)[1], []).append((s.path, q))
    bearing: Dict[_Key, str] = {}
    edges: Dict[_Key, List[Tuple[_Key, ast.Call]]] = {}
    for s in scopes.values():
        for q, fn in s.functions.items():
            cls = q.rsplit(".", 1)[0] if "." in q else None
            cls = cls if cls in s.classes else None
            out = edges.setdefault((s.path, q), [])
            for call in astutil.calls_in(fn):
                if astutil.enclosing_function(call) is not fn:
                    continue  # a nested def's calls are its own
                if _collective(call):
                    bearing.setdefault((s.path, q), ast.unparse(call.func))
                else:
                    out.extend((k, call) for k in _callees(call, s, cls, by_dotted, methods))
    changed = True
    while changed:
        changed = False
        for key, out in edges.items():
            if key in bearing:
                continue
            for callee, _call in out:
                if callee in bearing and callee != key:
                    bearing[key] = f"{callee[1]} -> {bearing[callee]}"
                    changed = True
                    break
    return bearing, scopes, by_dotted, methods


def check(
    root: str,
    files: Optional[Sequence[str]] = None,
) -> List[Finding]:
    paths = list(files if files is not None else astutil.iter_py_files(root))
    trees: Dict[str, ast.Module] = {}
    for p in paths:
        t = astutil.parse_file(p)
        if t is not None:
            trees[p] = t
    bearing, scopes, by_dotted, methods = _collective_bearing(root, trees)

    findings: List[Finding] = []
    for path, tree in trees.items():
        relpath = astutil.rel(root, path)
        scope = scopes[path]
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = astutil.enclosing_function(node)
            if func is None:
                continue
            chain = None
            if not _collective(node):
                q = astutil.qualname(func)
                cls = q.rsplit(".", 1)[0] if "." in q else None
                cls = cls if cls in scope.classes else None
                reached = [k for k in _callees(node, scope, cls, by_dotted, methods)
                           if k in bearing]
                if not reached:
                    continue
                chain = f"{reached[0][1]} -> {bearing[reached[0]]}"
            guards = astutil.guarding_conditionals(node)
            if not guards:
                continue
            taints = _collect_taint(func)
            for test, _stmt in guards:
                verdict = _classify_test(test, *taints)
                if verdict is None:
                    continue
                kind, code, witness = verdict
                what = (
                    f"collective '{ast.unparse(node.func)}'"
                    if chain is None
                    else f"call to collective-bearing '{ast.unparse(node.func)}' "
                    f"({chain})"
                )
                findings.append(
                    Finding(
                        checker=CHECKER,
                        # all three divergence classes are deadlock
                        # hazards — data-dependent (ANL103) included
                        severity=ERROR,
                        path=relpath,
                        line=node.lineno,
                        code=code,
                        symbol=astutil.qualname(func),
                        message=(
                            f"{what} is guarded by a {kind} conditional "
                            f"`{witness}` (line {test.lineno}): ranks may "
                            "disagree about executing the collective — a "
                            "hung-job hazard (conditionally-skipped "
                            "collective). Hoist the collective out of the "
                            "branch or make the guard uniform (static "
                            "config, world size, torch.where)."
                        ),
                    )
                )
                break  # one finding per collective site is enough
    return findings

"""Shared AST plumbing for the port's static checkers (a copy of the JAX
package's ``analysis/astutil.py`` whose file discovery defaults to the
port: ``heat3d_tpu_torch/`` without its ``_build/`` plus ``chip_smoke.py``).

All checkers *parse* the files they audit (they never import them — a
fixture module full of seeded deadlocks must be analyzable without being
executable), so the common needs live here: file discovery, a parse
cache, parent links, dotted call-name resolution, and ancestor walks
(enclosing function, guarding conditionals, guarding ``try`` blocks).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Tuple

_PARSE_CACHE: Dict[str, ast.Module] = {}

# what the checkers scan by default: the port's package (its kernels'
# build directory holds no source of its own) and the on-card smoke script
PORT_SUBDIRS: Tuple[str, ...] = ("heat3d_tpu_torch",)
PORT_EXTRAS: Tuple[str, ...] = ("chip_smoke.py",)


def repo_root() -> str:
    """The checkout root: the directory holding the ``heat3d_tpu_torch``
    package (works from an installed location too, as long as the layout
    is a source checkout)."""
    import heat3d_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(heat3d_tpu_torch.__file__)))


def rel(root: str, path: str) -> str:
    return os.path.relpath(os.path.abspath(path), os.path.abspath(root))


def iter_py_files(
    root: str,
    subdirs: Tuple[str, ...] = PORT_SUBDIRS,
    extras: Tuple[str, ...] = PORT_EXTRAS,
    exclude_dirs: Tuple[str, ...] = ("__pycache__", "_build"),
) -> Iterator[str]:
    """Absolute paths of the .py files under ``root/subdirs`` plus the
    ``extras`` (root-relative), sorted for deterministic reports."""
    out: List[str] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d not in exclude_dirs]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    for extra in extras:
        p = os.path.join(root, extra)
        if os.path.isfile(p):
            out.append(p)
    return iter(sorted(out))


def parse_file(path: str) -> Optional[ast.Module]:
    """Parse (cached, parent-linked); None on unreadable/unparseable —
    the caller decides whether that itself is a finding."""
    path = os.path.abspath(path)
    if path in _PARSE_CACHE:
        return _PARSE_CACHE[path]
    try:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None
    add_parents(tree)
    _PARSE_CACHE[path] = tree
    return tree


def clear_cache() -> None:
    _PARSE_CACHE.clear()


def add_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None (calls/subscripts in
    the chain break it — ``obs.get().event`` resolves to None here and is
    handled by the taxonomy checker's method-name fallback)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def method_name(call: ast.Call) -> Optional[str]:
    """The trailing attribute of a call (``anything.event(...)`` ->
    ``event``), regardless of whether the receiver chain is resolvable."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def qualname(func: ast.AST) -> str:
    """``Class.method`` / ``outer.inner`` / ``func`` for a FunctionDef,
    from the parent chain."""
    parts = [func.name]  # type: ignore[union-attr]
    cur = getattr(func, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            parts.append(cur.name)
        cur = getattr(cur, "parent", None)
    return ".".join(reversed(parts))


def guarding_conditionals(node: ast.AST) -> List[Tuple[ast.AST, ast.AST]]:
    """(test, statement) for every ``if``/``while``/ternary ancestor whose
    body-or-orelse contains ``node`` — the Python-level control flow that
    decides whether ``node`` executes at trace time."""
    out: List[Tuple[ast.AST, ast.AST]] = []
    cur = node
    parent = getattr(node, "parent", None)
    while parent is not None:
        if isinstance(parent, (ast.If, ast.While)) and cur is not parent.test:
            out.append((parent.test, parent))
        elif isinstance(parent, ast.IfExp) and cur is not parent.test:
            out.append((parent.test, parent))
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break  # conditionals outside the enclosing function don't count
        cur, parent = parent, getattr(parent, "parent", None)
    return out


def guarding_handlers(node: ast.AST) -> List[List[str]]:
    """For each ``try`` ancestor that ``node`` sits in the *body* of (not
    a handler/finally), the list of caught exception-name strings of its
    handlers (``[]`` entry = bare ``except``, catches everything)."""
    out: List[List[str]] = []
    cur = node
    parent = getattr(node, "parent", None)
    while parent is not None:
        if isinstance(parent, ast.Try) and _in_try_body(parent, cur):
            names: List[str] = []
            for h in parent.handlers:
                names.extend(_handler_names(h))
            out.append(names)
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        cur, parent = parent, getattr(parent, "parent", None)
    return out


def _in_try_body(try_node: ast.Try, child: ast.AST) -> bool:
    return any(child is stmt for stmt in try_node.body)


def _handler_names(h: ast.ExceptHandler) -> List[str]:
    if h.type is None:
        return [""]  # bare except
    if isinstance(h.type, ast.Tuple):
        return [dotted_name(e) or "?" for e in h.type.elts]
    return [dotted_name(h.type) or "?"]


def names_in(node: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(node) if isinstance(n, ast.Name)]


def calls_in(node: ast.AST) -> List[ast.Call]:
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)]


def literal_str_arg(call: ast.Call, index: int = 0) -> Optional[str]:
    if len(call.args) > index:
        a = call.args[index]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    return None

"""Guarded-by pass: ``# guarded-by: <lock>`` annotation checking.

Convention (opt-in, per attribute):

    self._pending: List[int] = []   # guarded-by: _lock

declares that every read or write of ``self._pending`` anywhere in the
class must happen lexically inside ``with self._lock`` (or the Condition
aliased onto it).  Escape hatches:

- ``def flush(self):  # holds: _lock`` — the whole function runs with the
  lock held (callers acquire it);
- a ``# unguarded-ok`` trailing comment on an access line suppresses that
  single site (e.g. intentional lock-free fast paths).

``__init__`` is exempt (no concurrent access before construction
completes).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from ._model import Finding, FunctionInfo, Index

PASS = "guarded_by"
_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_]\w*)")
_OK_RE = re.compile(r"#\s*unguarded-ok\b")


def _annotations(index: Index) -> Dict[Tuple[str, str, str], str]:
    """(rel, Class, attr) -> guarding lock attr, from init-time
    assignments with a trailing guarded-by comment."""
    out: Dict[Tuple[str, str, str], str] = {}
    for (rel, qual), fn in index.functions.items():
        if fn.class_name is None:
            continue
        for stmt in ast.walk(fn.node):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            m = _GUARD_RE.search(fn.module.line_text(stmt.lineno))
            if not m:
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    out[(rel, fn.class_name, t.attr)] = m.group(1)
    return out


def run(index: Index) -> List[Finding]:
    guards = _annotations(index)
    if not guards:
        return []
    by_class: Dict[Tuple[str, str], Dict[str, str]] = {}
    for (rel, cls, attr), lock in guards.items():
        by_class.setdefault((rel, cls), {})[attr] = lock

    findings: List[Finding] = []
    for (rel, qual), fn in index.functions.items():
        cls = fn.class_name
        if cls is None or (rel, cls) not in by_class:
            continue
        if fn.node.name == "__init__":
            continue
        attrs = by_class[(rel, cls)]
        held_default = frozenset()
        mh = _HOLDS_RE.search(fn.module.line_text(fn.node.lineno))
        if mh:
            held_default = frozenset([mh.group(1)])
        findings.extend(_check_function(index, fn, attrs, held_default))
    return findings


def _check_function(index: Index, fn: FunctionInfo,
                    attrs: Dict[str, str],
                    held_default: frozenset) -> List[Finding]:
    out: List[Finding] = []
    seen: set = set()
    cls = fn.class_name

    def lock_names(lock_attr: str) -> frozenset:
        """The annotated lock plus any Condition aliased onto it."""
        names = {lock_attr}
        for lid, li in index.locks.items():
            if li.alias_of == f"{cls}.{lock_attr}" \
                    and lid.startswith(f"{cls}."):
                names.add(li.attr)
            if lid == f"{cls}.{lock_attr}" and li.alias_of:
                names.add(li.alias_of.rsplit(".", 1)[-1])
        return frozenset(names)

    def scan(stmts, held: frozenset) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue   # nested defs may run without the lock: their
                # accesses are checked only if they are functions in the
                # index with their own holds: annotation
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held
                for item in stmt.items:
                    ce = item.context_expr
                    if (isinstance(ce, ast.Attribute)
                            and isinstance(ce.value, ast.Name)
                            and ce.value.id == "self"):
                        inner = inner | {ce.attr}
                    check_expr(item.context_expr, held)
                scan(stmt.body, inner)
                continue
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    check_expr(child, held)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list) and sub and \
                        isinstance(sub[0], ast.stmt):
                    scan(sub, held)
            for h in getattr(stmt, "handlers", []) or []:
                scan(h.body, held)

    def check_expr(node: ast.AST, held: frozenset) -> None:
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                continue
            if (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self" and n.attr in attrs):
                lock = attrs[n.attr]
                if not (lock_names(lock) & held):
                    if not _OK_RE.search(
                            fn.module.line_text(n.lineno)):
                        site = (n.attr, n.lineno)
                        if site not in seen:
                            seen.add(site)
                            out.append(Finding(
                                PASS, "unguarded-access",
                                fn.module.rel, fn.qualname, n.attr,
                                f"self.{n.attr} (guarded-by "
                                f"{lock}) accessed without holding "
                                f"self.{lock} in {fn.qualname}",
                                n.lineno))
            stack.extend(ast.iter_child_nodes(n))

    scan(fn.node.body, held_default)
    return out

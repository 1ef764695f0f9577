"""Shared AST model for the ray_tpu_torch static analyzer (the port's copy
of ``ray_tpu/analysis/_model.py``; what differs is in ROADMAP §C).

Builds a repo-wide index over the parsed sources:

- every module / class / function (including nested defs), keyed by
  ``(module, qualname)``;
- every ``threading.Lock/RLock/Condition`` the repo creates, identified as
  ``Class.attr`` (instance locks) or ``modbase.name`` (module-level locks),
  with ``Condition(self.x)`` aliased onto its underlying lock;
- lightweight type facts: module-level singletons (``VAR = Class()``),
  instance attributes (``self.x = Class()``), ``Dict[...]``-annotation value
  types, and parameter annotations — enough to resolve ``st.cv`` or
  ``self.core._pump()`` without importing anything.

All passes consume this index; nothing here imports the analyzed code.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

LOCK_CTORS = {"Lock": "Lock", "RLock": "RLock", "Condition": "Condition"}


def repo_root() -> str:
    """Directory that contains the ``ray_tpu_torch`` package."""
    import ray_tpu_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        ray_tpu_torch.__file__)))


@dataclasses.dataclass
class Finding:
    pass_id: str
    rule: str
    file: str          # rel path, forward slashes
    func: str          # module-level qualname ('' for module scope)
    detail: str        # stable discriminator (no line numbers)
    message: str
    line: int
    ordinal: int = 0   # >0 when the same key occurs repeatedly

    @property
    def key(self) -> str:
        k = f"{self.pass_id}:{self.rule}:{self.file}:{self.func}:{self.detail}"
        if self.ordinal:
            k += f"#{self.ordinal}"
        return k

    def render(self) -> str:
        return (f"{self.file}:{self.line}: [{self.pass_id}/{self.rule}] "
                f"{self.message}")


class ModuleInfo:
    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel                      # e.g. ray_tpu_torch/_private/core.py
        self.name = rel[:-3].replace("/", ".")  # dotted, for display
        self.base = self.name.rsplit(".", 1)[-1]
        self.source_lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # local name -> dotted module/thing it refers to
        self.imports: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = (
                        f"{node.module}.{a.name}")

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.source_lines):
            return self.source_lines[lineno - 1]
        return ""


@dataclasses.dataclass
class FunctionInfo:
    module: ModuleInfo
    qualname: str                       # Class.meth / func / func.inner
    node: ast.AST                       # FunctionDef | AsyncFunctionDef
    class_name: Optional[str]           # innermost enclosing class

    @property
    def key(self) -> Tuple[str, str]:
        return (self.module.rel, self.qualname)

    @property
    def is_async(self) -> bool:
        return isinstance(self.node, ast.AsyncFunctionDef)


@dataclasses.dataclass
class LockInfo:
    lock_id: str        # "Class.attr" or "modbase.name"
    kind: str           # Lock | RLock | Condition
    module: ModuleInfo
    line: int
    alias_of: Optional[str] = None   # Condition(self.x) -> underlying lock

    @property
    def reentrant(self) -> bool:
        return self.kind == "RLock"

    @property
    def attr(self) -> str:
        return self.lock_id.rsplit(".", 1)[-1]


def dotted(node: ast.AST) -> Optional[List[str]]:
    """['self','streams','get'] for self.streams.get; None if not a pure
    Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def _is_lock_ctor(call: ast.AST) -> Optional[str]:
    """'Lock'/'RLock'/'Condition' if ``call`` constructs a threading
    primitive (threading.Lock() or bare Lock() via from-import)."""
    if not isinstance(call, ast.Call):
        return None
    chain = dotted(call.func)
    if not chain:
        return None
    if chain[-1] in LOCK_CTORS and (len(chain) == 1
                                    or chain[0] == "threading"):
        return chain[-1]
    return None


def collect_modules(paths: Sequence[str], root: str) -> List[ModuleInfo]:
    """Parse every .py under ``paths``; fixture modules are excluded from
    directory walks (tests pass them explicitly)."""
    files: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            if (os.path.basename(dirpath) == "fixtures"
                    and os.path.basename(os.path.dirname(dirpath))
                    == "analysis"):
                continue
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    files.append(os.path.join(dirpath, fn))
    out = []
    for f in sorted(set(files)):
        rel = os.path.relpath(f, root).replace(os.sep, "/")
        try:
            with open(f, "r", encoding="utf-8") as fh:
                src = fh.read()
            out.append(ModuleInfo(f, rel, src))
        except (OSError, SyntaxError):
            continue
    return out


class Index:
    """Cross-module symbol, lock and type index."""

    def __init__(self, modules: List[ModuleInfo]):
        self.modules = modules
        self.functions: Dict[Tuple[str, str], FunctionInfo] = {}
        self.locks: Dict[str, LockInfo] = {}
        self.lock_attr_index: Dict[str, Set[str]] = {}
        # (rel, var) -> class qualname for module-level VAR = Class()
        self.instance_types: Dict[Tuple[str, str], str] = {}
        # (rel, Class, attr) -> class name for self.attr = Class()
        self.attr_types: Dict[Tuple[str, str, str], str] = {}
        # (rel, Class, attr) -> value-class for self.attr: Dict[K, V]
        self.dict_value_types: Dict[Tuple[str, str, str], str] = {}
        self.classes: Dict[str, List[str]] = {}   # name -> [rel, ...]
        self.mod_by_rel = {m.rel: m for m in modules}
        # dotted module name suffix -> rel (for import resolution)
        self.mod_by_name = {m.name: m.rel for m in modules}
        for m in modules:
            self._index_module(m)
        self._resolve_lock_aliases()

    # ---------------- construction ----------------

    def _index_module(self, m: ModuleInfo) -> None:
        def visit(node, qual: str, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{qual}.{child.name}" if qual else child.name
                    self.functions[(m.rel, q)] = FunctionInfo(
                        m, q, child, cls)
                    self._scan_self_assigns(m, cls, child)
                    visit(child, q, cls)
                elif isinstance(child, ast.ClassDef):
                    q = f"{qual}.{child.name}" if qual else child.name
                    self.classes.setdefault(child.name, []).append(m.rel)
                    visit(child, q, child.name)
                else:
                    if cls is None and qual == "":
                        self._scan_module_stmt(m, child)
        visit(m.tree, "", None)

    def _scan_module_stmt(self, m: ModuleInfo, stmt: ast.AST) -> None:
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            return
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        value = stmt.value
        if value is None:
            return
        kind = _is_lock_ctor(value)
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            if kind:
                lid = f"{m.base}.{t.id}"
                self._add_lock(LockInfo(lid, kind, m, stmt.lineno))
            elif isinstance(value, ast.Call):
                chain = dotted(value.func)
                if chain and chain[-1][:1].isupper():
                    self.instance_types[(m.rel, t.id)] = chain[-1]

    def _scan_self_assigns(self, m: ModuleInfo, cls: Optional[str],
                           fn: ast.AST) -> None:
        if cls is None:
            return
        for stmt in ast.walk(fn):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt is not fn:
                continue
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            value = stmt.value
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                kind = _is_lock_ctor(value) if value is not None else None
                if kind:
                    li = LockInfo(f"{cls}.{t.attr}", kind, m, stmt.lineno)
                    if (kind == "Condition" and value.args
                            and dotted(value.args[0])
                            and dotted(value.args[0])[0] == "self"):
                        li.alias_of = f"{cls}.{dotted(value.args[0])[-1]}"
                    self._add_lock(li)
                elif value is not None and isinstance(value, ast.Call):
                    chain = dotted(value.func)
                    if chain and chain[-1][:1].isupper():
                        self.attr_types[(m.rel, cls, t.attr)] = chain[-1]
                if isinstance(stmt, ast.AnnAssign):
                    vt = _dict_value_class(stmt.annotation)
                    if vt:
                        self.dict_value_types[(m.rel, cls, t.attr)] = vt

    def _add_lock(self, li: LockInfo) -> None:
        if li.lock_id in self.locks:
            # keep the first definition; re-assignments are common
            return
        self.locks[li.lock_id] = li
        self.lock_attr_index.setdefault(li.attr, set()).add(li.lock_id)

    def _resolve_lock_aliases(self) -> None:
        for li in self.locks.values():
            if li.alias_of and li.alias_of not in self.locks:
                li.alias_of = None

    # ---------------- queries ----------------

    def canon_lock(self, lock_id: str) -> str:
        li = self.locks.get(lock_id)
        if li is not None and li.alias_of:
            return li.alias_of
        return lock_id

    def resolve_lock(self, expr: ast.AST, fn: FunctionInfo,
                     local_types: Dict[str, str]) -> Optional[str]:
        """Lock id for an expression like ``self._lock`` / ``st.cv`` /
        ``_metric_lock``; None if it isn't (or can't be proven) a lock."""
        chain = dotted(expr)
        if not chain:
            return None
        m = fn.module
        if chain[0] == "self" and fn.class_name and len(chain) == 2:
            lid = f"{fn.class_name}.{chain[1]}"
            if lid in self.locks:
                return self.canon_lock(lid)
        if len(chain) == 1:
            lid = f"{m.base}.{chain[0]}"
            if lid in self.locks:
                return self.canon_lock(lid)
            return None
        if len(chain) == 2 and chain[0] != "self":
            # typed local / param: st.cv with st: StreamState
            t = local_types.get(chain[0])
            if t:
                lid = f"{t}.{chain[1]}"
                if lid in self.locks:
                    return self.canon_lock(lid)
            # module-level singleton: _registry.lock
            cls = self.instance_types.get((m.rel, chain[0]))
            if cls:
                lid = f"{cls}.{chain[1]}"
                if lid in self.locks:
                    return self.canon_lock(lid)
            # imported module's lock: othermod._lock
            tgt = m.imports.get(chain[0])
            if tgt:
                lid = f"{tgt.rsplit('.', 1)[-1]}.{chain[1]}"
                if lid in self.locks:
                    return self.canon_lock(lid)
        # last resort: attr name unique across every known lock
        cands = self.lock_attr_index.get(chain[-1], set())
        if len(cands) == 1:
            return self.canon_lock(next(iter(cands)))
        return None

    def resolve_call(self, func_expr: ast.AST, fn: FunctionInfo,
                     local_types: Dict[str, str]
                     ) -> Optional[Tuple[str, str]]:
        """(rel, qualname) of the called function, if statically known."""
        chain = dotted(func_expr)
        if not chain:
            return None
        m = fn.module
        if len(chain) == 1:
            name = chain[0]
            k = (m.rel, f"{fn.qualname}.{name}")      # nested sibling
            if k in self.functions:
                return k
            if fn.class_name:
                k = (m.rel, f"{fn.class_name}.{name}")
                if k in self.functions:
                    return k
            k = (m.rel, name)
            if k in self.functions:
                return k
            return None
        recv, meth = chain[:-1], chain[-1]
        cls = None
        mod_rel = m.rel
        if recv == ["self"] and fn.class_name:
            cls = fn.class_name
        elif len(recv) == 2 and recv[0] == "self" and fn.class_name:
            cls = self.attr_types.get((m.rel, fn.class_name, recv[1]))
            if cls:
                mod_rel = self._class_module(cls, m) or m.rel
        elif len(recv) == 1:
            cls = local_types.get(recv[0]) \
                or self.instance_types.get((m.rel, recv[0]))
            if cls:
                mod_rel = self._class_module(cls, m) or m.rel
            else:
                tgt = m.imports.get(recv[0])
                if tgt:
                    rel = self._module_rel(tgt)
                    if rel and (rel, meth) in self.functions:
                        return (rel, meth)
                return None
        if cls:
            k = (mod_rel, f"{cls}.{meth}")
            if k in self.functions:
                return k
        return None

    def _class_module(self, cls: str, prefer: ModuleInfo) -> Optional[str]:
        rels = self.classes.get(cls) or []
        if prefer.rel in rels:
            return prefer.rel
        return rels[0] if len(rels) == 1 else None

    def _module_rel(self, dotted_name: str) -> Optional[str]:
        if dotted_name in self.mod_by_name:
            return self.mod_by_name[dotted_name]
        for name, rel in self.mod_by_name.items():
            if name.endswith("." + dotted_name) \
                    or dotted_name.endswith("." + name.rsplit(".", 1)[-1]):
                if name.rsplit(".", 1)[-1] == dotted_name.rsplit(".", 1)[-1]:
                    return rel
        return None

    def local_types_for(self, fn: FunctionInfo) -> Dict[str, str]:
        """Best-effort local-variable -> class-name map for ``fn``:
        parameter annotations, ``v = Class()``, and
        ``v = self.<dict-attr>.get/[...]`` via Dict[...] annotations."""
        out: Dict[str, str] = {}
        args = fn.node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            if a.annotation is not None:
                ch = dotted(a.annotation)
                if ch and ch[-1] in self.classes:
                    out[a.arg] = ch[-1]
        for stmt in ast.walk(fn.node):
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            t = stmt.targets[0]
            if not isinstance(t, ast.Name):
                continue
            v = stmt.value
            ch = dotted(v.func) if isinstance(v, ast.Call) else None
            if ch and ch[-1] in self.classes and len(ch) <= 2:
                out[t.id] = ch[-1]
            elif (ch and len(ch) == 3 and ch[0] == "self"
                  and ch[-1] == "get" and fn.class_name):
                vt = self.dict_value_types.get(
                    (fn.module.rel, fn.class_name, ch[1]))
                if vt:
                    out[t.id] = vt
            elif (isinstance(v, ast.Subscript)
                  and isinstance(v.value, ast.Attribute)
                  and isinstance(v.value.value, ast.Name)
                  and v.value.value.id == "self" and fn.class_name):
                vt = self.dict_value_types.get(
                    (fn.module.rel, fn.class_name, v.value.attr))
                if vt:
                    out[t.id] = vt
        return out


def _dict_value_class(ann: ast.AST) -> Optional[str]:
    """'StreamState' from an annotation like Dict[str, StreamState]."""
    if not isinstance(ann, ast.Subscript):
        return None
    base = dotted(ann.value)
    if not base or base[-1] not in ("Dict", "dict"):
        return None
    sl = ann.slice
    if isinstance(sl, ast.Tuple) and len(sl.elts) == 2:
        ch = dotted(sl.elts[1])
        if ch:
            return ch[-1]
    return None


# ---------------- blocking-call classification ----------------

# attribute names that denote a (potentially) blocking operation in this
# codebase: raw sockets, concurrent futures, thread joins, framed-RPC sends
# (Deferred.resolve/reject and ServerConn.push/reply do sock.sendall) and
# the blocking client RPC (.call / kv polls go through it).
BLOCKING_ATTRS = {
    "recv", "recv_into", "recvfrom", "accept", "connect", "sendall",
    "sendmsg", "join", "result", "call", "wait",
    "resolve", "reject", "push", "reply", "reply_error",
}
_JOIN_SAFE_ROOTS = {"os", "posixpath", "ntpath", "shlex", "string"}


def blocking_symbol(call: ast.Call, module: ModuleInfo,
                    held_attrs: Set[str]) -> Optional[str]:
    """Symbol like 'time.sleep' or '.recv' if ``call`` looks blocking;
    ``held_attrs`` are the attr-parts of currently-held locks (so
    ``cv.wait`` on the held condition is not flagged)."""
    func = call.func
    chain = dotted(func)
    if chain:
        if chain[-1] == "sleep" and (len(chain) == 1
                                     or chain[0] == "time"):
            # bare sleep only if imported from time
            if len(chain) > 1 or \
                    module.imports.get("sleep", "") == "time.sleep":
                return "time.sleep"
        # the port's code spells the runtime ``ray_tpu_torch.get`` or
        # through an alias (``import ray_tpu_torch as rt``: ``rt.get``)
        if len(chain) == 2 and chain[-1] in ("get", "wait") and (
                chain[0] == "ray_tpu_torch"
                or module.imports.get(chain[0]) == "ray_tpu_torch"):
            return f"ray_tpu_torch.{chain[-1]}"
    if not isinstance(func, ast.Attribute):
        return None
    attr = func.attr
    if attr not in BLOCKING_ATTRS:
        return None
    recv = func.value
    if attr == "join":
        if isinstance(recv, (ast.Constant, ast.JoinedStr)):
            return None                       # ",".join(...)
        if chain and (chain[0] in _JOIN_SAFE_ROOTS or "path" in chain[:-1]):
            return None                       # os.path.join
    if attr in ("wait", "acquire", "notify", "notify_all"):
        # condition-variable idiom: waiting on the lock you hold releases
        # it — not a held-across-blocking hazard
        if chain and (chain[-2] in held_attrs if len(chain) >= 2
                      else chain[0] in held_attrs):
            return None
    if chain and chain[0] == "asyncio":
        return None
    return f".{attr}"


def walk_calls(node: ast.AST):
    """Yield every Call lexically inside ``node``, NOT descending into
    nested function/class definitions or lambdas."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))

"""Torch-purity pass: host syncs, side effects and nondeterminism inside
the port's hot bodies, the counterpart of ``ray_tpu/analysis/jax_purity.py``.

A traced JAX body runs once per signature and is frozen; a PyTorch body
runs on every call, so its counterpart is a *hot* body: one whose cost or
determinism the device path pays on every step.  Hot-body discovery (all
static, nothing is imported):

- instrumented programs: the first argument of ``instrument(fn, name=)``
  (``telemetry.device``'s, whatever the receiver: ``devtel.instrument``,
  a bare ``instrument``) resolved as a def of the module, a module
  attribute the index knows (``gpt_mod.paged_prefill``), either branch of
  a conditional or the function of a ``functools.partial``; and the
  decorator forms ``@devtel.instrument`` /
  ``@functools.partial(devtel.instrument, name=...)``;
- Triton kernels: ``@triton.jit`` bodies (the counterpart of a Pallas
  kernel; ``@triton.autotune`` above it changes nothing);
- compiled and captured bodies: torch's ``compile`` as a decorator or
  a wrap (``compile(fn)``), ``torch.cuda.make_graphed_callables(fn, ...)``,
  and the statements of a ``with torch.cuda.graph(g):`` block (checked as
  a region of the enclosing function); names resolve through the
  module's imports, aliases included;
- nested defs inside any of the above (``ast.walk`` reaches them);
- callees, transitively: every call in a hot body that resolves to a def
  of the package (a module function by name, a from-imported function, a
  function of an imported module, a method through ``self`` or a typed
  local, a module a local holds: ``model = model_of(cfg)`` returns
  ``gpt`` or ``moe``, so ``model._loss`` reaches both; a class a factory
  returns and the method an attribute of it binds; ``self.meth`` reaches
  the base's definition and every subclass's override).  A trace covers its
  callees; a hot body's callees run on every step just the same, so
  ``jax_env.rollout`` under Anakin's loop is hot.  A wrapped ``X.f`` whose
  ``X`` is no import (the engine's ``gpt_mod`` parameter) names the one
  module-level def ``f`` of the package, if only one exists.

Rules inside a hot body (one per rule of the reference's pass):

- ``side-effect``       ``print`` / ``open`` / ``global``;
- ``host-sync``         ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                        ``.numpy()``, ``np.asarray`` / ``np.array``,
                        ``torch.cuda.synchronize`` and ``.synchronize()``,
                        and the data-dependent shapes ``nonzero`` /
                        ``unique`` / ``unique_consecutive`` /
                        ``masked_select`` without a static ``size=``: each
                        waits for the card;
- ``nondeterminism``    ``torch.rand*`` / ``randint`` / ``randperm`` /
                        ``multinomial`` / ``bernoulli`` / ``normal`` /
                        ``poisson`` and the in-place samplers
                        (``normal_``, ``uniform_``, ...) without
                        ``generator=``; stdlib ``random.*``;
                        ``np.random.*``; ``time.time`` and its kin;
- ``unhashable-static`` an instrumented program's argument that is not in
                        its ``dynamic_argnames`` with a mutable default,
                        or given a list/dict/set literal at a call site in
                        its module: the ledger keys a signature on such a
                        value by value (``telemetry/device.py``
                        ``_signature_key``), so each call can be a new
                        signature.

Plus one rule about where the wrap itself happens:

- ``build-per-call``    ``instrument``, torch's ``compile`` or a kernel
                        library load (``ctypes.CDLL``, the ``_kernels``
                        build) inside a ``for``/``while`` loop or a
                        comprehension, or a wrap
                        of a callable built per call (a local def, a
                        lambda, an inline ``partial``) invoked in the same
                        scope; a decorated local def likewise.  Factories
                        that *return* the wrapper are fine.

``# torch-ok`` on the offending line suppresses a site.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ._model import Finding, FunctionInfo, Index, ModuleInfo, dotted

PASS = "torch_purity"
OK = "# torch-ok"

_TIME_FNS = {"time", "monotonic", "perf_counter", "time_ns",
             "monotonic_ns", "perf_counter_ns"}
# ``x.attr()`` with no arguments that copies a tensor to the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# data-dependent output shapes: the host waits to learn the size
_SHAPE_SYNC = {"nonzero", "unique", "unique_consecutive", "masked_select"}
# torch.<fn>(...) samplers that draw from the global generator unless
# given ``generator=``
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "rand_like",
                   "randn_like", "randint_like", "multinomial",
                   "bernoulli", "normal", "poisson"}
# tensor.<fn>(...) samplers (methods, in place or not)
_METHOD_SAMPLERS = {"multinomial", "bernoulli", "bernoulli_", "normal_",
                    "uniform_", "random_", "exponential_", "geometric_",
                    "log_normal_", "cauchy_"}
# what a kernel library load is called
_LIB_LOADS = {"CDLL"}
_KERNEL_BUILDS = {"build", "_load"}

Key = Tuple[str, str]


# ---------------------------------------------------------------------------
# import resolution within the package
# ---------------------------------------------------------------------------

def _pkg_imports(m: ModuleInfo) -> Dict[str, str]:
    """Local name -> absolute dotted name, for the names a module imports
    from its own package (relative imports, or absolute ones under the
    package's top-level name).  External packages are left out, so
    ``torch.x`` never resolves to a module of the port that happens to be
    called ``torch``."""
    top = m.name.split(".", 1)[0]
    here = m.name.split(".")[:-1]      # the module's package
    out: Dict[str, str] = {}
    for node in ast.walk(m.tree):
        if isinstance(node, ast.ImportFrom):
            if node.level:
                base = here[:len(here) - node.level + 1]
                full = ".".join(base + ([node.module] if node.module
                                        else []))
            elif node.module and node.module.split(".")[0] == top:
                full = node.module
            else:
                continue
            for a in node.names:
                out[a.asname or a.name] = f"{full}.{a.name}"
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == top and a.asname:
                    out[a.asname] = a.name
    return out


class _Resolver:
    """Call and reference resolution for the hot-body closure."""

    def __init__(self, index: Index):
        self.index = index
        self._imports: Dict[str, Dict[str, str]] = {}
        self._types: Dict[Key, Dict[str, str]] = {}
        self._scopes: Dict[Key, Dict[str, Tuple[str, List[str]]]] = {}
        self._bases: Optional[Dict[str, Set[str]]] = None
        self._subs: Optional[Dict[str, Set[str]]] = None
        self._unique: Optional[Dict[str, Key]] = None

    def imports(self, m: ModuleInfo) -> Dict[str, str]:
        got = self._imports.get(m.rel)
        if got is None:
            got = self._imports[m.rel] = _pkg_imports(m)
        return got

    def local_types(self, fn: FunctionInfo) -> Dict[str, str]:
        got = self._types.get(fn.key)
        if got is None:
            got = self._types[fn.key] = self.index.local_types_for(fn)
        return got

    def _by_dotted(self, name: str, depth: int = 0) -> Optional[Key]:
        """The def ``pkg.mod.func`` names, following a package's
        re-exports (``from ray_tpu_torch.ops import attention``)."""
        mod, _, attr = name.rpartition(".")
        rel = self.index.mod_by_name.get(mod) \
            or self.index.mod_by_name.get(f"{mod}.__init__")
        if not rel:
            return None
        if (rel, attr) in self.index.functions:
            return (rel, attr)
        again = self.imports(self.index.mod_by_rel[rel]).get(attr)
        if again and again != name and depth < 4:
            return self._by_dotted(again, depth + 1)
        return None

    def ref(self, expr: ast.AST, fn: Optional[FunctionInfo],
            m: ModuleInfo) -> Optional[Key]:
        """The def a reference (not a call) names: ``step``,
        ``gpt_mod.paged_prefill``, ``self._fwd``."""
        chain = dotted(expr)
        if not chain:
            return None
        if fn is not None:
            k = self.index.resolve_call(expr, fn, self.local_types(fn))
            if k:
                return k
        elif len(chain) == 1 and (m.rel, chain[0]) in self.index.functions:
            return (m.rel, chain[0])
        imp = self.imports(m)
        tgt = imp.get(chain[0])
        if tgt is None:
            return None
        if len(chain) == 1:
            return self._by_dotted(tgt)
        if len(chain) == 2:
            return self._by_dotted(f"{tgt}.{chain[1]}")
        return None

    def by_unique_name(self, expr: ast.AST) -> Optional[Key]:
        """``X.f`` handed to a wrap where ``X`` is no import (a
        parameter holding a module: the engine's ``gpt_mod``): the one
        module-level def named ``f`` in the package, if there is one."""
        chain = dotted(expr)
        if not chain or len(chain) != 2 or chain[0] == "self":
            return None
        if self._unique is None:
            count: Dict[str, List[Key]] = {}
            for k in self.index.functions:
                if "." not in k[1]:
                    count.setdefault(k[1], []).append(k)
            self._unique = {n: ks[0] for n, ks in count.items()
                            if len(ks) == 1}
        return self._unique.get(chain[1])

    # -- what a local name holds ------------------------------------------

    def scope(self, fn: FunctionInfo) -> Dict[str, Tuple[str, List[str]]]:
        """Local name -> what it holds, seen through enclosing functions
        (a nested def reads their locals):

        - ``("modules", [dotted, ...])``: ``x = gpt`` (an imported module)
          or ``x = f(...)`` where every ``return`` of ``f`` is one
          (``model = model_of(cfg)`` gives ``gpt`` and ``moe``);
        - ``("class", [Name])``: ``x = f(...)`` where every ``return`` of
          ``f`` constructs that class (``make_impala_learner``);
        - ``("funcs", [rel::qualname, ...])``: ``y = x.attr`` where the
          class of ``x`` binds ``self.attr = self.meth``
          (``update_fn = learner._update_fn``)."""
        got = self._scopes.get(fn.key)
        if got is not None:
            return got
        got = self._scopes[fn.key] = {}
        rel, qual = fn.key
        if "." in qual:
            outer = self.index.functions.get((rel, qual.rsplit(".", 1)[0]))
            if outer is not None:
                got.update(self.scope(outer))
        for stmt in ast.walk(fn.node):
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                continue
            v, name = stmt.value, stmt.targets[0].id
            if isinstance(v, ast.Name):
                mods = self._module_names(fn.module, [v])
                if mods:
                    got[name] = ("modules", mods)
            elif isinstance(v, ast.Call):
                k = self.ref(v.func, fn, fn.module)
                if k is None:
                    continue
                callee = self.index.functions[k]
                rets = [n.value for n in ast.walk(callee.node)
                        if isinstance(n, ast.Return) and n.value is not None]
                mods = self._module_names(callee.module, rets) if rets \
                    else []
                if mods:
                    got[name] = ("modules", mods)
                    continue
                cls = {dotted(r.func)[-1] for r in rets
                       if isinstance(r, ast.Call) and dotted(r.func)}
                if rets and len(cls) == 1 and all(
                        isinstance(r, ast.Call) for r in rets) \
                        and next(iter(cls)) in self.index.classes:
                    got[name] = ("class", sorted(cls))
            elif isinstance(v, ast.Attribute) and isinstance(v.value,
                                                             ast.Name):
                held = got.get(v.value.id)
                if held and held[0] == "class":
                    keys = self._bound_method(held[1][0], v.attr)
                    if keys:
                        got[name] = ("funcs", [f"{r}::{q}" for r, q in keys])
        return got

    def _module_names(self, m: ModuleInfo, exprs: List[ast.AST]
                      ) -> List[str]:
        out = []
        imp = self.imports(m)
        for e in exprs:
            if isinstance(e, ast.IfExp):
                got = self._module_names(m, [e.body, e.orelse])
                if not got:
                    return []
                out += got
                continue
            if not isinstance(e, ast.Name):
                return []
            tgt = imp.get(e.id)
            if tgt is None or tgt not in self.index.mod_by_name:
                return []
            out.append(tgt)
        return out

    # -- classes: bases, overrides -------------------------------------------

    def _hierarchy(self):
        if self._bases is None:
            self._bases, self._subs = {}, {}
            for m in self.index.modules:
                for node in ast.walk(m.tree):
                    if isinstance(node, ast.ClassDef):
                        names = [dotted(b)[-1] for b in node.bases
                                 if dotted(b)]
                        self._bases.setdefault(node.name, set()).update(
                            names)
                        for b in names:
                            self._subs.setdefault(b, set()).add(node.name)
        return self._bases, self._subs

    def _related(self, cls: str, table: Dict[str, Set[str]]) -> List[str]:
        out, todo = [], [cls]
        while todo:
            c = todo.pop()
            if c in out:
                continue
            out.append(c)
            todo.extend(sorted(table.get(c, ())))
        return out

    def _methods(self, cls: str, meth: str) -> List[Key]:
        """``cls.meth`` as dispatch can reach it: the first definition up
        the bases, and every override in the subclasses."""
        bases, subs = self._hierarchy()
        out: List[Key] = []
        for c in self._related(cls, bases):
            hit = [(rel, f"{c}.{meth}") for rel in self.index.classes.get(
                c, []) if (rel, f"{c}.{meth}") in self.index.functions]
            if hit:
                out += hit
                break
        for c in self._related(cls, subs)[1:]:
            out += [(rel, f"{c}.{meth}") for rel in self.index.classes.get(
                c, []) if (rel, f"{c}.{meth}") in self.index.functions]
        return out

    def _bound_method(self, cls: str, attr: str) -> List[Key]:
        """The methods ``self.attr = self.meth`` binds in ``cls`` or its
        bases."""
        bases, _ = self._hierarchy()
        for c in self._related(cls, bases):
            for rel in self.index.classes.get(c, []):
                for (r, q), f in self.index.functions.items():
                    if r != rel or not q.startswith(f"{c}."):
                        continue
                    for st in ast.walk(f.node):
                        if isinstance(st, ast.Assign) and any(
                                dotted(t) == ["self", attr]
                                for t in st.targets):
                            ch = dotted(st.value)
                            if ch and len(ch) == 2 and ch[0] == "self":
                                return self._methods(cls, ch[1])
        return []

    def calls(self, call: ast.Call, fn: FunctionInfo) -> List[Key]:
        """The defs a call in ``fn`` can reach."""
        chain = dotted(call.func)
        if chain and len(chain) == 2 and chain[0] == "self" \
                and fn.class_name:
            got = self._methods(fn.class_name, chain[1])
            if got:
                return got
        k = self.index.resolve_call(call.func, fn, self.local_types(fn)) \
            or self.ref(call.func, fn, fn.module)
        if k is not None:
            return [k]
        if not chain:
            return []
        held = self.scope(fn).get(chain[0])
        if held is None:
            return []
        kind, what = held
        if kind == "funcs" and len(chain) == 1:
            return [tuple(w.split("::", 1)) for w in what]
        if len(chain) != 2:
            return []
        if kind == "modules":
            out = []
            for mod in what:
                r = self.index.mod_by_name[mod]
                if (r, chain[1]) in self.index.functions:
                    out.append((r, chain[1]))
            return out
        if kind == "class":
            return self._methods(what[0], chain[1])
        return []


def _targets(expr: ast.AST) -> List[ast.AST]:
    """The callables an ``instrument``/``compile`` argument can be:
    either branch of ``a if c else b``, the function of a
    ``partial(fn, ...)``."""
    if isinstance(expr, ast.IfExp):
        return _targets(expr.body) + _targets(expr.orelse)
    if isinstance(expr, ast.Call):
        ch = dotted(expr.func)
        if ch and ch[-1] == "partial" and expr.args:
            return _targets(expr.args[0])
        return []
    return [expr]


# ---------------------------------------------------------------------------
# what makes a body hot
# ---------------------------------------------------------------------------

def _is_instrument(chain: Optional[List[str]]) -> bool:
    return bool(chain) and chain[-1] == "instrument"


def _full(chain: Optional[List[str]], m: ModuleInfo) -> List[str]:
    """The dotted name a chain stands for, part by part, through the
    module's imports (``tc`` of ``from torch import compile as tc`` is
    torch's ``compile``)."""
    if not chain:
        return []
    return m.imports.get(chain[0], chain[0]).split(".") + chain[1:]


def _is_compile(chain: Optional[List[str]], m: ModuleInfo) -> bool:
    full = _full(chain, m)
    return full == ["torch", "compile"] \
        or full[-1:] == ["make_graphed_callables"]


def _is_triton_jit(chain: Optional[List[str]], m: ModuleInfo) -> bool:
    return _full(chain, m) == ["triton", "jit"]


def _is_graph_ctx(expr: ast.AST, m: ModuleInfo) -> bool:
    return isinstance(expr, ast.Call) \
        and _full(dotted(expr.func), m) == ["torch", "cuda", "graph"]


def _wrap_kind(chain: Optional[List[str]], m: ModuleInfo) -> bool:
    """``instrument``, torch's ``compile``, ``make_graphed_callables``."""
    return _is_instrument(chain) or _is_compile(chain, m)


def _hot_decorator(dec: ast.expr, m: ModuleInfo) -> bool:
    """@devtel.instrument / @instrument(...) / @partial(instrument, ...) /
    torch's @compile and @compile(...) / @triton.jit."""
    ch = dotted(dec)
    if _wrap_kind(ch, m) or _is_triton_jit(ch, m):
        return True
    if isinstance(dec, ast.Call):
        fch = dotted(dec.func)
        if _wrap_kind(fch, m) or _is_triton_jit(fch, m):
            return True
        if fch and fch[-1] == "partial" and dec.args:
            ach = dotted(dec.args[0])
            return _wrap_kind(ach, m) or _is_triton_jit(ach, m)
    return False


def _dynamic_names(call: ast.Call) -> Set[str]:
    out: Set[str] = set()
    for kw in call.keywords:
        if kw.arg == "dynamic_argnames":
            v = kw.value
            elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) else \
                ([v] if isinstance(v, ast.Constant) else [])
            for e in elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    out.add(e.value)
    return out


class _Program:
    """One instrumented program: its def and the names it is called by."""

    def __init__(self, key: Key, dynamic: Set[str]):
        self.key = key
        self.dynamic = set(dynamic)
        self.names: Set[str] = set()


def _enclosing(index: Index, m: ModuleInfo) -> Dict[int, FunctionInfo]:
    """id(node) -> the innermost function of ``m`` lexically holding it."""
    out: Dict[int, FunctionInfo] = {}
    fns = [f for (rel, _), f in index.functions.items() if rel == m.rel]
    # outer functions first, so inner ones overwrite their nodes
    for f in sorted(fns, key=lambda f: f.qualname.count(".")):
        for n in ast.walk(f.node):
            out[id(n)] = f
    return out


def _discover(index: Index, res: _Resolver):
    """-> (hot function keys, hot ``with`` regions, instrumented
    programs by key)."""
    hot: Set[Key] = set()
    regions: List[Tuple[FunctionInfo, List[ast.stmt]]] = []
    programs: Dict[Key, _Program] = {}
    for key, fn in index.functions.items():
        for dec in getattr(fn.node, "decorator_list", []):
            if _hot_decorator(dec, fn.module):
                hot.add(key)
                dch = dotted(dec.func) if isinstance(dec, ast.Call) else \
                    dotted(dec)
                if isinstance(dec, ast.Call) and dch \
                        and dch[-1] == "partial" and dec.args:
                    dch = dotted(dec.args[0])
                if _is_instrument(dch):
                    p = programs.setdefault(key, _Program(
                        key, _dynamic_names(dec)
                        if isinstance(dec, ast.Call) else set()))
                    p.names.add(fn.node.name)
    for m in index.modules:
        owner: Optional[Dict[int, FunctionInfo]] = None
        for node in ast.walk(m.tree):
            if isinstance(node, ast.With):
                if not any(_is_graph_ctx(it.context_expr, m)
                           for it in node.items):
                    continue
                if owner is None:
                    owner = _enclosing(index, m)
                fn = owner.get(id(node))
                if fn is not None:
                    regions.append((fn, list(node.body)))
                continue
            if not isinstance(node, ast.Call) or not node.args:
                continue
            chain = dotted(node.func)
            if not _wrap_kind(chain, m):
                continue
            if owner is None:
                owner = _enclosing(index, m)
            fn = owner.get(id(node))
            for t in _targets(node.args[0]):
                k = res.ref(t, fn, m) or res.by_unique_name(t)
                if k is None:
                    continue
                hot.add(k)
                if _is_instrument(chain):
                    p = programs.setdefault(k, _Program(
                        k, _dynamic_names(node)))
                    tch = dotted(t)
                    if tch and k[0] == m.rel:
                        p.names.add(tch[-1])
        # names an instrumented program is bound to in this module
        for node in ast.walk(m.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _is_instrument(dotted(node.value.func))
                    and node.value.args):
                continue
            owner = owner or _enclosing(index, m)
            fn = owner.get(id(node))
            for t in _targets(node.value.args[0]):
                k = res.ref(t, fn, m)
                if k is None or k not in programs:
                    continue
                for tgt in node.targets:
                    tch = dotted(tgt)
                    if tch:
                        programs[k].names.add(tch[-1])
    return hot, regions, programs


def _closure(index: Index, res: _Resolver, hot: Set[Key],
             regions: List[Tuple[FunctionInfo, List[ast.stmt]]]
             ) -> Set[Key]:
    """Every def reachable from a hot body or region through resolved
    calls (nested defs are walked with their outer body)."""
    seen: Set[Key] = set()
    todo: List[Tuple[FunctionInfo, List[ast.AST]]] = [
        (index.functions[k], [index.functions[k].node]) for k in hot]
    todo += [(fn, list(body)) for fn, body in regions]
    while todo:
        fn, roots = todo.pop()
        if len(roots) == 1 and roots[0] is fn.node:
            if fn.key in seen:
                continue
            seen.add(fn.key)
        for root in roots:
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                for k in res.calls(node, fn):
                    if k not in seen and k in index.functions:
                        todo.append((index.functions[k],
                                     [index.functions[k].node]))
    return seen


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def run(index: Index) -> List[Finding]:
    res = _Resolver(index)
    hot, regions, programs = _discover(index, res)
    closure = _closure(index, res, hot, regions)
    findings: List[Finding] = []
    for key in sorted(closure):
        fn = index.functions[key]
        findings.extend(_check_body(fn, [fn.node], closure))
    for fn, body in regions:
        if fn.key not in closure:
            findings.extend(_check_body(fn, body, closure))
    for key in sorted(programs):
        findings.extend(_check_program_defaults(index, programs[key]))
    findings.extend(_check_call_sites(index, programs))
    findings.extend(_check_build_per_call(index))
    return findings


def _ok(fn: FunctionInfo, line: int) -> bool:
    return OK in fn.module.line_text(line)


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def _own_nodes(fn: FunctionInfo, roots: List[ast.AST],
               closure: Set[Key]) -> List[ast.AST]:
    """The nodes under ``roots``, less the bodies of nested defs that are
    hot in their own right (each site is reported once, under its own
    def)."""
    out: List[ast.AST] = []
    stack = [(r, fn.qualname) for r in roots]
    while stack:
        n, qual = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and n is not fn.node:
            q = f"{qual}.{n.name}"
            if (fn.module.rel, q) in closure:
                continue
            stack.extend((c, q) for c in ast.iter_child_nodes(n))
            continue
        out.append(n)
        stack.extend((c, qual) for c in ast.iter_child_nodes(n))
    return out


def _check_body(fn: FunctionInfo, roots: List[ast.AST],
                closure: Set[Key]) -> List[Finding]:
    out: List[Finding] = []
    mod = fn.module
    np_names = {k for k, v in mod.imports.items() if v == "numpy"}
    torch_names = {k for k, v in mod.imports.items() if v == "torch"}
    has_random = mod.imports.get("random", "") == "random"
    has_time = mod.imports.get("time", "") == "time"

    def add(rule: str, detail: str, msg: str, line: int) -> None:
        if not _ok(fn, line):
            out.append(Finding(PASS, rule, mod.rel, fn.qualname,
                               detail, msg, line))

    for node in _own_nodes(fn, roots, closure):
        if isinstance(node, ast.Global):
            add("side-effect", "global",
                f"`global` statement inside hot {fn.qualname}",
                node.lineno)
            continue
        if not isinstance(node, ast.Call):
            continue
        chain = dotted(node.func)
        name = ".".join(chain) if chain else ""
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if chain in (["print"], ["open"]):
            add("side-effect", chain[0],
                f"{chain[0]}() inside hot {fn.qualname} runs on the host "
                f"on every call", node.lineno)
        elif chain and chain[0] in np_names and len(chain) >= 2:
            if chain[1] == "random":
                add("nondeterminism", name,
                    f"unseeded {name} inside hot {fn.qualname}",
                    node.lineno)
            elif chain[-1] in ("asarray", "array"):
                add("host-sync", name,
                    f"{name} inside hot {fn.qualname} copies a tensor to "
                    f"the host (a device->host sync)", node.lineno)
        elif chain and chain[0] == "random" and has_random \
                and len(chain) == 2:
            add("nondeterminism", name,
                f"unseeded stdlib {name} inside hot {fn.qualname}",
                node.lineno)
        elif chain and chain[0] == "time" and has_time \
                and len(chain) == 2 and chain[1] in _TIME_FNS:
            add("nondeterminism", name,
                f"{name} inside hot {fn.qualname} makes its result "
                f"depend on the clock", node.lineno)
        elif chain and len(chain) == 3 and chain[0] in torch_names \
                and chain[1:] == ["cuda", "synchronize"]:
            add("host-sync", "torch.cuda.synchronize",
                f"torch.cuda.synchronize inside hot {fn.qualname} waits "
                f"for the card", node.lineno)
        elif chain and len(chain) == 2 and chain[0] in torch_names \
                and chain[1] in _TORCH_SAMPLERS:
            if not _has_kw(node, "generator"):
                add("nondeterminism", f"torch.{chain[1]}",
                    f"torch.{chain[1]} without generator= inside hot "
                    f"{fn.qualname} draws from the global generator",
                    node.lineno)
        elif chain and len(chain) == 2 and chain[0] in torch_names \
                and chain[1] in _SHAPE_SYNC:
            if not _has_kw(node, "size"):
                add("host-sync", f"torch.{chain[1]}",
                    f"torch.{chain[1]} inside hot {fn.qualname} has a "
                    f"data-dependent shape (a device->host sync)",
                    node.lineno)
        elif attr in _SYNC_METHODS and not node.args and not node.keywords:
            add("host-sync", f".{attr}",
                f".{attr}() inside hot {fn.qualname} copies to the host "
                f"(a device->host sync)", node.lineno)
        elif attr == "synchronize" and not node.args:
            add("host-sync", ".synchronize",
                f".synchronize() inside hot {fn.qualname} waits for the "
                f"card", node.lineno)
        elif attr in _SHAPE_SYNC and not _has_kw(node, "size"):
            add("host-sync", f".{attr}",
                f".{attr}() inside hot {fn.qualname} has a data-dependent "
                f"shape (a device->host sync)", node.lineno)
        elif attr in _METHOD_SAMPLERS and not _has_kw(node, "generator"):
            add("nondeterminism", f".{attr}",
                f".{attr}() without generator= inside hot {fn.qualname} "
                f"draws from the global generator", node.lineno)
    return out


def _param_defaults(node: ast.AST):
    args = node.args
    defaults = list(args.defaults)
    pos = list(args.posonlyargs) + list(args.args)
    pos_with_default = pos[len(pos) - len(defaults):] if defaults else []
    return list(zip(pos_with_default, defaults)) + [
        (a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
        if d is not None]


_MUTABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
            ast.SetComp)


def _check_program_defaults(index: Index, prog: _Program) -> List[Finding]:
    fn = index.functions[prog.key]
    out: List[Finding] = []
    for a, d in _param_defaults(fn.node):
        if a.arg in prog.dynamic or not isinstance(d, _MUTABLE):
            continue
        if not _ok(fn, d.lineno):
            out.append(Finding(
                PASS, "unhashable-static", fn.module.rel, fn.qualname,
                f"default:{a.arg}",
                f"argument {a.arg!r} of instrumented {fn.qualname} has a "
                f"mutable {type(d).__name__.lower()} default and is not "
                f"in its dynamic_argnames (the ledger keys it by value)",
                d.lineno))
    return out


def _check_call_sites(index: Index,
                      programs: Dict[Key, _Program]) -> List[Finding]:
    by_name: Dict[Tuple[str, str], _Program] = {}
    for p in programs.values():
        for n in p.names:
            by_name[(p.key[0], n)] = p
    out: List[Finding] = []
    if not by_name:
        return out
    for (rel, qual), fn in index.functions.items():
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            chain = dotted(node.func)
            if not chain or (chain[0] != "self" and len(chain) != 1) \
                    or len(chain) > 2:
                continue
            prog = by_name.get((rel, chain[-1]))
            if prog is None:
                continue
            target = index.functions[prog.key].node.args
            params = [a.arg for a in list(target.posonlyargs)
                      + list(target.args)]
            named = [(params[i], v) for i, v in enumerate(node.args)
                     if i < len(params)]
            named += [(kw.arg, kw.value) for kw in node.keywords
                      if kw.arg is not None]
            for arg, value in named:
                if arg in prog.dynamic or not isinstance(value, _MUTABLE):
                    continue
                if not _ok(fn, node.lineno):
                    out.append(Finding(
                        PASS, "unhashable-static", rel, qual,
                        f"call:{chain[-1]}:{arg}",
                        f"a {type(value).__name__.lower()} literal passed "
                        f"for {arg!r} of instrumented {chain[-1]} in "
                        f"{qual} (not in its dynamic_argnames: a new "
                        f"signature per value)", node.lineno))
    return out


def _build_kind(chain: Optional[List[str]], m: ModuleInfo) -> Optional[str]:
    """'wrap' for instrument or torch's compile, 'load' for a kernel
    library load (ctypes.CDLL, ``_kernels.build``/``_kernels._load``)."""
    if _wrap_kind(chain, m):
        return "wrap"
    if chain and chain[-1] in _LIB_LOADS:
        return "load"
    if chain and len(chain) >= 2 and chain[-2] == "_kernels" \
            and chain[-1] in _KERNEL_BUILDS:
        return "load"
    return None


def _wrap_target(call: ast.Call) -> Tuple[str, bool]:
    """(display name, built-per-call?) for the callable a wrap receives:
    lambdas, inline ``partial(...)`` and other call results are fresh
    objects on every evaluation."""
    t = call.args[0]
    if isinstance(t, ast.Lambda):
        return "<lambda>", True
    if isinstance(t, ast.Call):
        tch = dotted(t.func)
        if tch and tch[-1] == "partial" and t.args:
            inner = dotted(t.args[0])
            return (inner[-1] if inner else "<partial>"), True
        return (tch[-1] if tch else "<call>") + "()", True
    ch = dotted(t)
    return (".".join(ch) if ch else "<expr>"), False


# a comprehension evaluates its element once per item, as a loop body does
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)


def _check_build_per_call(index: Index) -> List[Finding]:
    """Wraps and library loads whose result cannot outlive the call: in a
    loop body, or a wrap of a per-call callable invoked in the same
    scope."""
    out: List[Finding] = []
    for key, fn in sorted(index.functions.items()):
        rel, qual = key
        nodes: List[Tuple[ast.AST, int]] = []
        stack = [(c, 0) for c in ast.iter_child_nodes(fn.node)]
        while stack:
            n, depth = stack.pop()
            nodes.append((n, depth))
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            d = depth + 1 if isinstance(n, _LOOPS) else depth
            stack.extend((c, d) for c in ast.iter_child_nodes(n))

        builds: List[Tuple[ast.Call, int, str]] = []
        called_names: Set[str] = set()
        invoked: Set[int] = set()            # id() of wrap(f)(x) wraps
        assigns: List[ast.Assign] = []
        nested_defs: List[Tuple[ast.AST, int]] = []
        for n, depth in nodes:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested_defs.append((n, depth))
                continue
            if isinstance(n, ast.Assign):
                assigns.append(n)
            if not isinstance(n, ast.Call):
                continue
            if isinstance(n.func, ast.Name):
                called_names.add(n.func.id)
            if isinstance(n.func, ast.Call):
                invoked.add(id(n.func))
            chain = dotted(n.func)
            kind = _build_kind(chain, fn.module)
            if kind is not None:
                builds.append((n, depth, kind))

        def add(detail: str, msg: str, line: int) -> None:
            if not _ok(fn, line):
                out.append(Finding(PASS, "build-per-call", rel, qual,
                                   detail, msg, line))

        for call, depth, kind in builds:
            if kind == "load":
                if depth > 0:
                    what = dotted(call.func)[-1]
                    add(f"loop:{what}",
                        f"{what}() inside a loop in {qual} loads a kernel "
                        f"library per iteration — hoist it", call.lineno)
                continue
            if not call.args:
                continue
            name, per_call = _wrap_target(call)
            if depth > 0:
                add(f"loop:{name}",
                    f"a wrap of {name} inside a loop in {qual} builds a "
                    f"fresh program per iteration — hoist it out of the "
                    f"loop", call.lineno)
                continue
            local_def = (not per_call and "." not in name
                         and (rel, f"{qual}.{name}") in index.functions)
            if not (per_call or local_def):
                continue
            hit = id(call) in invoked
            if not hit:
                for a in assigns:
                    if any(n is call for n in ast.walk(a.value)):
                        hit = any(isinstance(t, ast.Name)
                                  and t.id in called_names
                                  for t in a.targets)
                        if hit:
                            break
            if hit:
                add(f"closure:{name}",
                    f"a wrap of {name} (built per call) is invoked in the "
                    f"same scope ({qual}) — every call of {qual} makes a "
                    f"new program; hoist the wrap or return it",
                    call.lineno)

        for nd, depth in nested_defs:
            decs = [d for d in getattr(nd, "decorator_list", [])
                    if _hot_decorator(d, fn.module)]
            if not decs:
                continue
            line = decs[0].lineno
            if depth > 0:
                add(f"loop:{nd.name}",
                    f"decorated def {nd.name} inside a loop in {qual} is "
                    f"rebuilt every iteration — hoist it", line)
            elif nd.name in called_names:
                add(f"closure:{nd.name}",
                    f"decorated def {nd.name} is local to {qual} and "
                    f"called there — every call of {qual} rebuilds it; "
                    f"hoist it or return it", line)
    return out

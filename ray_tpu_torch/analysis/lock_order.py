"""Lock-order pass: acquisition-order cycles and locks held across
blocking calls.

Per function we track the lexically-held lock set through ``with``
statements, recording (held -> acquired) edges both for direct nested
acquisitions and — via a transitive-acquisition fixpoint over the resolved
call graph — for calls made while holding a lock.  Cycles in the resulting
digraph (Tarjan SCCs) are deadlock candidates; a self-edge on a
non-reentrant Lock/Condition is a guaranteed self-deadlock.

Blocking calls (socket recv/sendall, framed-RPC resolve/push/reply,
Future.result, thread join, blocking client .call, time.sleep) made while
any lock is held are flagged directly, and one call level deep (a call to
a function whose own body blocks).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ._model import (Finding, FunctionInfo, Index, blocking_symbol, dotted)

PASS = "lock_order"


class _FuncFacts:
    def __init__(self) -> None:
        # (held tuple, lock, line) for every acquisition site
        self.acquisitions: List[Tuple[Tuple[str, ...], str, int]] = []
        # (held tuple, callee key, display name, line)
        self.calls: List[Tuple[Tuple[str, ...],
                               Optional[Tuple[str, str]], str, int]] = []
        # (held tuple, symbol, line) for blocking calls in this body
        self.blocking: List[Tuple[Tuple[str, ...], str, int]] = []
        self.acq_direct: Set[str] = set()
        self.blocks_direct: bool = False
        self.acq_trans: Set[str] = set()


def _suppressed(fn: FunctionInfo, line: int) -> bool:
    return "# lock-ok" in fn.module.line_text(line)


def _scan_function(index: Index, fn: FunctionInfo) -> _FuncFacts:
    facts = _FuncFacts()
    local_types = index.local_types_for(fn)

    def held_attrs(held: Tuple[str, ...]) -> Set[str]:
        return {h.rsplit(".", 1)[-1] for h in held}

    def scan_expr(node: ast.AST, held: Tuple[str, ...]) -> None:
        for call in walk_calls_incl(node):
            chain = dotted(call.func)
            # explicit lock.acquire() counts as an acquisition event
            if (isinstance(call.func, ast.Attribute)
                    and call.func.attr == "acquire"):
                lock = index.resolve_lock(call.func.value, fn, local_types)
                if lock:
                    facts.acquisitions.append((held, lock, call.lineno))
                    continue
            if (isinstance(call.func, ast.Attribute)
                    and call.func.attr == "wait"):
                # cv.wait releases the condition's underlying lock: not a
                # held-across-blocking hazard when that lock is the one
                # held (directly or via a Condition alias)
                lk = index.resolve_lock(call.func.value, fn, local_types)
                if lk and lk in held:
                    continue
            sym = blocking_symbol(call, fn.module, held_attrs(held))
            if sym:
                facts.blocking.append((held, sym, call.lineno))
            callee = index.resolve_call(call.func, fn, local_types)
            name = ".".join(chain) if chain else "?"
            facts.calls.append((held, callee, name, call.lineno))

    def walk_calls_incl(node: ast.AST):
        # expression-level call walk that does not descend into lambdas
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Call):
                yield n
            stack.extend(ast.iter_child_nodes(n))

    def scan_body(stmts, held: Tuple[str, ...]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue    # nested defs run later, analyzed separately
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held
                for item in stmt.items:
                    scan_expr(item.context_expr, inner)
                    lock = index.resolve_lock(item.context_expr, fn,
                                              local_types)
                    if lock:
                        facts.acquisitions.append(
                            (inner, lock, stmt.lineno))
                        inner = inner + (lock,)
                scan_body(stmt.body, inner)
                continue
            # every direct expression child, then nested statement blocks
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    scan_expr(child, held)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list) and sub and \
                        isinstance(sub[0], ast.stmt):
                    scan_body(sub, held)
            for h in getattr(stmt, "handlers", []) or []:
                if h.type is not None:
                    scan_expr(h.type, held)
                scan_body(h.body, held)

    scan_body(fn.node.body, ())
    facts.acq_direct = {a[1] for a in facts.acquisitions}
    facts.blocks_direct = bool(facts.blocking)
    return facts


def _budgeted_handlers(index: Index) -> Dict[Tuple[str, str], str]:
    """(module rel, handler function name) -> budgeted RPC method, from
    ``.handle("method", self.h_x)`` registration calls against the
    runtime budget table (rpc_stats.HANDLER_BUDGETS_MS).  A budgeted
    handler runs on a server event loop with a latency ceiling: holding
    a lock across a blocking call there is not a style warning, it is a
    stall of every connection — the lock-held-blocking pass promotes it
    to a distinct, never-baselined rule."""
    try:
        from ray_tpu_torch._private.rpc_stats import HANDLER_BUDGETS_MS
    except Exception:   # analyzer must stand alone if the runtime moved
        return {}
    out: Dict[Tuple[str, str], str] = {}
    for m in index.modules:
        for node in ast.walk(m.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "handle"
                    and len(node.args) >= 2):
                continue
            meth = node.args[0]
            target = node.args[1]
            if not (isinstance(meth, ast.Constant)
                    and isinstance(meth.value, str)
                    and meth.value in HANDLER_BUDGETS_MS):
                continue
            if isinstance(target, ast.Attribute):
                out[(m.rel, target.attr)] = meth.value
            elif isinstance(target, ast.Name):
                out[(m.rel, target.id)] = meth.value
    return out


def run(index: Index) -> List[Finding]:
    facts: Dict[Tuple[str, str], _FuncFacts] = {}
    for key, fn in index.functions.items():
        facts[key] = _scan_function(index, fn)
    budgeted = _budgeted_handlers(index)

    def budget_method(fn: FunctionInfo) -> Optional[str]:
        # nested defs inside a handler (waiter closures etc.) run on the
        # same dispatch, so any qualname segment naming a budgeted
        # handler taints the whole function
        for seg in fn.qualname.split("."):
            meth = budgeted.get((fn.module.rel, seg))
            if meth is not None:
                return meth
        return None

    # transitive acquired-locks fixpoint over the resolved call graph
    for f in facts.values():
        f.acq_trans = set(f.acq_direct)
    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for f in facts.values():
            for _, callee, _, _ in f.calls:
                if callee and callee in facts:
                    extra = facts[callee].acq_trans - f.acq_trans
                    if extra:
                        f.acq_trans |= extra
                        changed = True

    findings: List[Finding] = []
    # edges: (src lock, dst lock) -> (file, func, line, via)
    edges: Dict[Tuple[str, str], Tuple[str, str, int, str]] = {}

    def add_edge(src: str, dst: str, fn: FunctionInfo, line: int,
                 via: str) -> None:
        if (src, dst) not in edges:
            edges[(src, dst)] = (fn.module.rel, fn.qualname, line, via)

    for key, f in facts.items():
        fn = index.functions[key]
        for held, lock, line in f.acquisitions:
            for h in held:
                if h != lock:
                    add_edge(h, lock, fn, line, "direct")
            if lock in held and not index.locks[lock].reentrant \
                    and not _suppressed(fn, line):
                findings.append(Finding(
                    PASS, "lock-self-reacquire", fn.module.rel,
                    fn.qualname, lock,
                    f"non-reentrant {lock} re-acquired while already "
                    f"held in {fn.qualname}", line))
        for held, callee, name, line in f.calls:
            if not held or callee not in facts:
                continue
            for lock in facts[callee].acq_trans:
                for h in held:
                    if h != lock:
                        add_edge(h, lock, fn, line, name)

    # acquisition-order cycles: Tarjan SCCs of the lock digraph
    for scc in _sccs({s for s, _ in edges} | {d for _, d in edges},
                     edges):
        if len(scc) < 2:
            continue
        members = sorted(scc)
        sites = []
        for (s, d), (rel, qn, line, via) in sorted(edges.items()):
            if s in scc and d in scc:
                sites.append(f"{s}->{d} at {rel}:{line} ({qn})")
        # anchor the finding to the first lock's definition site so the
        # key stays stable as call sites move around
        li = index.locks.get(members[0])
        rel = li.module.rel if li else "?"
        line = li.line if li else 0
        findings.append(Finding(
            PASS, "lock-order-cycle", rel, "", "<->".join(members),
            "lock acquisition-order cycle: " + "; ".join(sites), line))

    # locks held across blocking calls (direct + one call level deep)
    for key, f in facts.items():
        fn = index.functions[key]
        direct_lines = set()
        meth = budget_method(fn)
        for held, sym, line in f.blocking:
            if held and not _suppressed(fn, line):
                direct_lines.add(line)
                findings.append(Finding(
                    PASS, "lock-held-blocking", fn.module.rel,
                    fn.qualname, f"{held[-1]}:{sym}",
                    f"blocking call {sym} while holding "
                    f"{', '.join(held)} in {fn.qualname}", line))
                if meth is not None:
                    findings.append(Finding(
                        PASS, "budget-held-blocking", fn.module.rel,
                        fn.qualname, f"{meth}:{held[-1]}:{sym}",
                        f"blocking call {sym} while holding "
                        f"{', '.join(held)} in {fn.qualname} — handler "
                        f"of budgeted RPC {meth!r} "
                        f"(rpc_stats.HANDLER_BUDGETS_MS); it stalls the "
                        f"server event loop past its latency budget",
                        line))
        for held, callee, name, line in f.calls:
            if not held or callee not in facts:
                continue
            if line in direct_lines:
                continue    # already reported as a direct blocking call
            cf = facts[callee]
            if any(not ch for ch, _, _ in cf.blocking) \
                    and not _suppressed(fn, line):
                findings.append(Finding(
                    PASS, "lock-held-blocking", fn.module.rel,
                    fn.qualname, f"{held[-1]}:call:{name}",
                    f"call to {name} (which blocks) while holding "
                    f"{', '.join(held)} in {fn.qualname}", line))
                if meth is not None:
                    findings.append(Finding(
                        PASS, "budget-held-blocking", fn.module.rel,
                        fn.qualname, f"{meth}:{held[-1]}:call:{name}",
                        f"call to {name} (which blocks) while holding "
                        f"{', '.join(held)} in {fn.qualname} — handler "
                        f"of budgeted RPC {meth!r} "
                        f"(rpc_stats.HANDLER_BUDGETS_MS); it stalls the "
                        f"server event loop past its latency budget",
                        line))
    return findings


def _sccs(nodes: Set[str], edges: Dict[Tuple[str, str], object]):
    """Iterative Tarjan strongly-connected components."""
    adj: Dict[str, List[str]] = {n: [] for n in nodes}
    for (s, d) in edges:
        adj[s].append(d)
    idx: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]

    for root in sorted(nodes):
        if root in idx:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                idx[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on.add(v)
            advanced = False
            for i in range(pi, len(adj[v])):
                w = adj[v][i]
                if w not in idx:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if w in on:
                    low[v] = min(low[v], idx[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == idx[v]:
                comp = set()
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.add(w)
                    if w == v:
                        break
                out.append(comp)
    return out

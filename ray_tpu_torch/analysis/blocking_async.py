"""Blocking-in-async pass: blocking calls inside ``async def`` bodies.

An event loop that executes ``time.sleep``, a raw ``socket.recv``, a
blocking RPC ``.call`` (every KV poll goes through it), ``Future.result``
or ``ray_tpu_torch.get`` stalls every coroutine on that loop.  Anything under an
``await`` is fine by construction; nested *sync* defs are excluded (they
run wherever they're called); ``# async-ok`` suppresses a site.
"""

from __future__ import annotations

import ast
from typing import List

from ._model import Finding, Index, blocking_symbol, walk_calls

PASS = "blocking_async"


def run(index: Index) -> List[Finding]:
    findings: List[Finding] = []
    for (rel, qual), fn in index.functions.items():
        if not fn.is_async:
            continue
        awaited = {id(c) for c in _awaited_calls(fn.node)}
        for call in walk_calls(fn.node):
            if id(call) in awaited:
                continue
            sym = blocking_symbol(call, fn.module, set())
            if sym is None:
                continue
            if "# async-ok" in fn.module.line_text(call.lineno):
                continue
            findings.append(Finding(
                PASS, "blocking-in-async", rel, qual, sym,
                f"blocking call {sym} inside async def {qual} "
                f"(stalls the event loop)", call.lineno))
    return findings


def _awaited_calls(root: ast.AST):
    for node in ast.walk(root):
        if isinstance(node, ast.Await) and \
                isinstance(node.value, ast.Call):
            yield node.value

"""Repo-aware static analysis for ray_tpu_torch
(``python -m ray_tpu_torch analyze``), the port's copy of
``ray_tpu/analysis``.

Four AST-based passes over the port's sources:

- ``lock_order``      acquisition-order cycles + locks held across blocking
                      calls, interprocedural across the concurrency-heavy
                      modules (core, control, worker_proc, recorder, engine,
                      metrics).
- ``guarded_by``      ``# guarded-by: <lock>`` annotations on shared mutable
                      attributes, checked at every access site.
- ``blocking_async``  blocking calls (time.sleep / socket / RPC) inside
                      ``async def`` bodies in serve/, dag/, util/client/.
- ``torch_purity``    the counterpart of the reference's ``jax_purity``:
                      side effects, host syncs, unseeded draws and clock
                      reads, unhashable static arguments and per-call
                      builds inside hot bodies (instrumented programs,
                      Triton kernels, compiled or graph-captured bodies and
                      everything they call) in ops/, models/, collective/,
                      parallel/ and rl/.

Findings carry stable keys (no line numbers) and are diffed against the
port's own checked-in ``analysis_baseline_torch.json`` (the reference's
``analysis_baseline.json`` is not read): pre-existing findings are
suppressed, any *new* finding fails CI.  Nothing here imports torch, JAX
or the analyzed code.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

from ._model import Finding, Index, collect_modules, repo_root
from . import baseline
from .lock_order import run as _run_lock_order
from .guarded_by import run as _run_guarded_by
from .blocking_async import run as _run_blocking_async
from .torch_purity import run as _run_torch_purity

__all__ = [
    "Finding",
    "Index",
    "PASSES",
    "baseline",
    "collect_modules",
    "repo_root",
    "run_analysis",
]

# pass name -> (runner, default report scope: rel-path prefixes, or None=all)
PASSES = {
    "lock_order": (_run_lock_order, (
        "ray_tpu_torch/_private/core.py",
        "ray_tpu_torch/_private/control.py",
        "ray_tpu_torch/_private/worker_proc.py",
        "ray_tpu_torch/telemetry/recorder.py",
        "ray_tpu_torch/serve/_engine.py",
        "ray_tpu_torch/serve/_router.py",
        "ray_tpu_torch/util/metrics.py",
    )),
    "guarded_by": (_run_guarded_by, None),
    "blocking_async": (_run_blocking_async, (
        "ray_tpu_torch/serve/",
        "ray_tpu_torch/dag/",
        "ray_tpu_torch/util/client/",
    )),
    "torch_purity": (_run_torch_purity, (
        "ray_tpu_torch/ops/",
        "ray_tpu_torch/models/",
        "ray_tpu_torch/collective/",
        "ray_tpu_torch/parallel/",
        "ray_tpu_torch/rl/",
    )),
}


def run_analysis(paths: Optional[Sequence[str]] = None,
                 root: Optional[str] = None,
                 passes: Optional[Iterable[str]] = None) -> List[Finding]:
    """Analyze ``paths`` (files or directories; default: the ray_tpu_torch
    package).

    Directory scans report each pass only within its default scope;
    explicitly listed *files* are reported by every pass (this is how the
    fixture modules are driven from tests).  Returns findings with unique
    keys (duplicate sites get ``#n`` ordinals).
    """
    root = os.path.abspath(root or repo_root())
    if not paths:
        paths = [os.path.join(root, "ray_tpu_torch")]
    explicit: set = set()
    for p in paths:
        if os.path.isfile(p):
            explicit.add(os.path.relpath(os.path.abspath(p), root)
                         .replace(os.sep, "/"))
    modules = collect_modules(paths, root)
    index = Index(modules)
    findings: List[Finding] = []
    for name, (runner, scope) in PASSES.items():
        if passes is not None and name not in passes:
            continue
        got = runner(index)
        if scope is not None:
            got = [f for f in got
                   if f.file in explicit
                   or any(f.file == s or (s.endswith("/")
                                          and f.file.startswith(s))
                          for s in scope)]
        findings.extend(got)
    return _assign_keys(findings)


def _assign_keys(findings: List[Finding]) -> List[Finding]:
    """Dedupe identical sites and give repeats stable ``#n`` ordinals."""
    seen = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule,
                                             f.detail)):
        base = f.key
        n = seen.get(base, 0)
        seen[base] = n + 1
        if n:
            f.ordinal = n
        out.append(f)
    return out

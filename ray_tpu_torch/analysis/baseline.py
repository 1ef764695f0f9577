"""Baseline load/save/diff for the analyzer.

``analysis_baseline_torch.json`` (checked in at the repo root) records
every known finding of the port's scan by its stable key; the reference's
``analysis_baseline.json`` beside it belongs to ``ray_tpu`` and is never
read or written here.  ``diff()`` splits a fresh scan into
(new, known, stale): new findings fail CI, stale baseline entries are
reported informationally so the baseline can be re-shrunk with
``python -m ray_tpu_torch analyze --update-baseline``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from ._model import Finding, repo_root

VERSION = 1
DEFAULT_NAME = "analysis_baseline_torch.json"


def default_path() -> str:
    return os.path.join(repo_root(), DEFAULT_NAME)


def load(path: str) -> Dict[str, dict]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != VERSION:
        raise ValueError(
            f"unsupported baseline version {data.get('version')!r} "
            f"in {path}")
    return dict(data.get("findings", {}))


def save(path: str, findings: List[Finding]) -> None:
    payload = {
        "version": VERSION,
        "findings": {
            f.key: {"line": f.line, "message": f.message}
            for f in sorted(findings, key=lambda f: f.key)
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def diff(findings: List[Finding], known: Dict[str, dict]
         ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """-> (new, suppressed, stale_keys)."""
    new, suppressed = [], []
    seen = set()
    for f in findings:
        seen.add(f.key)
        (suppressed if f.key in known else new).append(f)
    stale = sorted(k for k in known if k not in seen)
    return new, suppressed, stale

"""Accepted-findings baseline (``analysis/baseline.txt``): the port's
copy of ``lightgbm_tpu/analysis/baseline.py``.

Format — one finding id per line, a ``#`` justification REQUIRED on
every entry (``lint --strict`` fails on one without: an acceptance
without a reason is just a suppressed bug)::

    # tpulint baseline
    TPL002:ops/grow.py:Grower._grow:.item()#1  # once a tree: ...

Ids are stable under line drift (rule + file + function + symbol +
ordinal — no line numbers), so refactors that merely move code never
churn the baseline. Stale entries (baselined findings that no longer
occur) are reported so the baseline only ever shrinks honestly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

__all__ = ["BaselineEntry", "load_baseline", "format_baseline",
           "assign_ids"]


@dataclass
class BaselineEntry:
    fid: str
    justification: str
    lineno: int


def load_baseline(path: str) -> List[BaselineEntry]:
    entries: List[BaselineEntry] = []
    if not os.path.exists(path):
        return entries
    with open(path, encoding="utf-8") as fh:
        for i, raw in enumerate(fh, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            # the id itself contains '#' (the ordinal) — the id is the
            # first whitespace-delimited token, the justification is
            # everything after the following '#'
            parts = line.split(None, 1)
            fid = parts[0]
            just = ""
            if len(parts) > 1:
                just = parts[1].lstrip("#").strip()
            if just.upper().startswith("TODO"):
                # --write-baseline skeletons: a TODO placeholder is NOT
                # a justification — the gate must keep failing until a
                # real reason replaces it
                just = ""
            entries.append(BaselineEntry(fid=fid, justification=just,
                                         lineno=i))
    return entries


def assign_ids(findings) -> None:
    """Stable finding ids: ``RULE:path:func:symbol#N`` where N orders
    same-keyed findings by line (1-based)."""
    groups: Dict[Tuple[str, str, str, str], list] = {}
    for f in findings:
        groups.setdefault((f.rule, f.relpath, f.func, f.symbol),
                          []).append(f)
    for (rule, rel, func, symbol), group in groups.items():
        group.sort(key=lambda f: (f.lineno, f.col))
        for i, f in enumerate(group, start=1):
            f.fid = f"{rule}:{rel}:{func}:{symbol}#{i}"


def format_baseline(findings) -> str:
    """Render findings as a baseline file body (justifications left as
    TODO markers for the author to fill in — the test rejects them
    until a real reason is written)."""
    lines = [
        "# tpulint baseline — accepted findings "
        "(python -m lightgbm_tpu_torch lint --baseline <this file>).",
        "# Every entry MUST carry a '#' justification; "
        "lint --strict enforces it.",
        "",
    ]
    for f in sorted(findings, key=lambda f: f.fid):
        lines.append(f"{f.fid}  # TODO: justify "
                     f"({f.relpath}:{f.lineno})")
    return "\n".join(lines) + "\n"

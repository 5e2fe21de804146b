"""Finding renderers: human text, machine JSON, and SARIF 2.1.0 (the
port's copy of ``lightgbm_tpu/analysis/report.py``).

SARIF (``lint --format sarif``) is the exchange format code-review
tooling ingests (GitHub code scanning, VS Code SARIF viewers): one
``run`` with the tpulint driver + rule catalog, one ``result`` per
non-baselined finding, with the stable line-number-free finding id in
``partialFingerprints`` so review systems track findings across code
motion exactly like the baseline does.
"""

from __future__ import annotations

import json
from typing import List

__all__ = ["render_text", "render_json", "render_sarif"]

_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                 "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def render_text(result) -> str:
    lines: List[str] = []
    for f in result.findings:
        lines.append(f"{f.relpath}:{f.lineno}:{f.col + 1}: "
                     f"{f.rule} [{f.fid}]")
        lines.append(f"    {f.message}")
    if result.stale_baseline:
        lines.append("")
        lines.append("stale baseline entries (finding no longer "
                     "occurs — delete them):")
        for e in result.stale_baseline:
            lines.append(f"    {e.fid}")
    if result.unjustified_baseline:
        lines.append("")
        lines.append("unjustified baseline entries (every entry needs "
                     "a '#' justification):")
        for e in result.unjustified_baseline:
            lines.append(f"    {e.fid}")
    if getattr(result, "stale_budget", None):
        lines.append("")
        lines.append("stale budgets.json entries (no spec runs "
                     "this entry — delete them):")
        for e in result.stale_budget:
            lines.append(f"    {e.fid}")
    if getattr(result, "unjustified_budget", None):
        lines.append("")
        lines.append("unjustified budgets.json entries (every "
                     "budget needs a real justification):")
        for e in result.unjustified_budget:
            lines.append(f"    {e.fid}")
    n = len(result.findings)
    b = len(result.baselined)
    ir = getattr(result, "ir_entries", None)
    lines.append("")
    lines.append(
        f"tpulint: {n} finding{'s' if n != 1 else ''}"
        + (f" ({b} baselined and suppressed)" if b else "")
        + f", {len(result.files)} files, "
        f"{len(result.graph.hot_reachable)} hot-reachable functions"
        + (f", {len(ir)} runtime entries run" if ir else "")
        + f", {result.elapsed:.2f}s")
    return "\n".join(lines)


def render_json(result) -> str:
    def fdict(f):
        return {"id": f.fid, "rule": f.rule, "path": f.relpath,
                "line": f.lineno, "col": f.col + 1, "function": f.func,
                "symbol": f.symbol, "message": f.message}

    return json.dumps({
        "findings": [fdict(f) for f in result.findings],
        "baselined": [fdict(f) for f in result.baselined],
        "stale_baseline": [e.fid for e in result.stale_baseline],
        "stale_budget": [e.fid for e in
                         getattr(result, "stale_budget", [])],
        "unjustified_budget": [e.fid for e in
                               getattr(result, "unjustified_budget",
                                       [])],
        "ir_entries": list(getattr(result, "ir_entries", [])),
        "files": sorted(result.files),
        "hot_reachable": sorted(
            f"{p}:{q}" for (p, q) in result.graph.hot_reachable),
        "elapsed_seconds": result.elapsed,
    }, indent=2, sort_keys=False)


def render_sarif(result) -> str:
    """SARIF 2.1.0 — attachable to code-review tooling. Non-baselined
    findings become ``results``; baselined ones ride along with a
    ``suppressions`` entry so code-review tools show the accepted set
    too."""
    from .rules import ALL_RULES, IR_RULES

    pkg = ""
    for s in result.graph.scans.values():
        pkg = s.module.split(".", 1)[0]
        break

    def _result(f, suppressed: bool):
        out = {
            "ruleId": f.rule,
            "level": "warning",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f"{pkg}/{f.relpath}" if pkg
                               else f.relpath,
                        "uriBaseId": "SRCROOT",
                    },
                    # IR findings without a source anchor carry line
                    # 0; SARIF requires startLine >= 1
                    "region": {"startLine": max(f.lineno, 1),
                               "startColumn": f.col + 1},
                },
                "logicalLocations": [{
                    "name": f.func,
                    "kind": "function",
                }],
            }],
            "partialFingerprints": {"tpulintFindingId/v1": f.fid},
        }
        if suppressed:
            out["suppressions"] = [{
                "kind": "external",
                "justification": "accepted in analysis/baseline.txt",
            }]
        return out

    payload = {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "tpulint",
                "informationUri":
                    f"{pkg or 'lightgbm_tpu_torch'}/analysis/cli.py",
                "rules": [{
                    "id": r.id,
                    "shortDescription": {"text": r.title},
                    "helpUri": f"{pkg or 'lightgbm_tpu_torch'}"
                               "/analysis/rules.py",
                } for r in ALL_RULES + IR_RULES],
            }},
            "results": [_result(f, False) for f in result.findings]
            + [_result(f, True) for f in result.baselined],
        }],
    }
    return json.dumps(payload, indent=2)

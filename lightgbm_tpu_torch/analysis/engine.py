"""Lint engine: scan -> callgraph -> rules -> baseline filter.

The port's copy of ``lightgbm_tpu/analysis/engine.py``. ``run_lint`` is
the one library entry point; the CLI
(:mod:`~lightgbm_tpu_torch.analysis.cli`) and the tests
(``tests/test_torch_lint.py``) are thin layers over it. Pure stdlib —
no torch import anywhere on this path but ``ir=True``'s.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set

from .baseline import (BaselineEntry, assign_ids, format_baseline,
                       load_baseline)
from .callgraph import CallGraph, scan_package
from .rules import (ALL_RULES, NO_COUNTERPART, Finding, LintContext,
                    rule_by_id)

__all__ = ["run_lint", "LintResult", "default_scope", "package_root",
           "default_baseline_path"]

#: rule scope, the JAX package's: the boosting hot path (models/, ops/,
#: parallel/, engine.py, resilience/), obs/ for TPL006, data/ for the
#: ingestion's host collectives (TPL007), serve/ for the daemon's
#: batcher/watcher thread contract (TPL006/TPL008) and its compiled
#: forest (TPL003), pipeline.py for the load generator's thread
#: contract, and every module that emits events, bumps metrics or reads
#: LIGHTGBM_TPU_* env vars (the contract pass TPL015-TPL018). The
#: analyzer itself (analysis/) is not in it.
_SCOPE_DIRS = ("models/", "ops/", "parallel/", "resilience/", "obs/",
               "data/", "serve/", "utils/")
_SCOPE_FILES = ("engine.py", "ranking.py", "prediction.py",
                "metrics.py", "objectives.py", "shap.py",
                "pipeline.py", "basic.py", "cli.py", "config.py",
                "callback.py")


def package_root() -> str:
    """Directory of the ``lightgbm_tpu_torch`` package being analyzed."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_baseline_path(root: Optional[str] = None) -> str:
    """``analysis/baseline.txt`` inside the analyzed package."""
    root = root or package_root()
    return os.path.join(root, "analysis", "baseline.txt")


def default_scope(relpaths: Sequence[str]) -> Set[str]:
    out = set()
    for rel in relpaths:
        if rel in _SCOPE_FILES or rel.startswith(_SCOPE_DIRS):
            out.add(rel)
    return out


@dataclass
class LintResult:
    findings: List[Finding]                  # non-baselined, sorted
    baselined: List[Finding]
    stale_baseline: List[BaselineEntry]
    suppressed: List[Finding]                # pragma-disabled
    files: Set[str]
    graph: CallGraph
    elapsed: float
    unjustified_baseline: List[BaselineEntry] = field(
        default_factory=list)
    # --ir only: budget-file discipline (analysis/budgets.json keys
    # that no spec runs anymore / that lack a real justification)
    # and the entry points the IR pass actually ran
    stale_budget: List[BaselineEntry] = field(default_factory=list)
    unjustified_budget: List[BaselineEntry] = field(
        default_factory=list)
    ir_entries: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def write_baseline(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(format_baseline(self.findings + self.baselined))


def run_lint(root: Optional[str] = None,
             package: str = "lightgbm_tpu_torch",
             scope: Optional[Set[str]] = None,
             rules: Optional[Sequence[str]] = None,
             baseline_path: Optional[str] = None,
             files: Optional[List[str]] = None,
             ir: bool = False,
             ir_entries: Optional[Sequence[str]] = None) -> LintResult:
    """Run the analyzer.

    Args:
      root: package directory to scan (default: this installation's
        ``lightgbm_tpu_torch``). The whole package is always parsed for
        the call graph; ``scope`` limits where rules REPORT.
      scope: relpaths rules run over (default: the hot-path scope).
      rules: rule ids to run (default: all AST rules; the runtime rules
        TPL011, TPL012 and TPL014 additionally require ``ir=True``).
        A JAX rule without a port counterpart (TPL001, TPL004, TPL013)
        raises ``ValueError`` naming its ROADMAP.md entry.
      baseline_path: accepted-findings file ("": no baseline;
        None: analysis/baseline.txt when present).
      files: restrict parsing to these package-relative files
        (fixture tests use this).
      ir: also run every registered entry point at small declared
        shapes on the CPU and check the runtime rules. This — and ONLY
        this — imports torch (lazily, on the CPU); the default path
        stays pure stdlib.
      ir_entries: restrict the runtime pass to these entries
        (``name@variant`` or bare registry name).
    """
    t0 = time.perf_counter()
    for rid in rules or ():
        if rid in NO_COUNTERPART:
            raise ValueError(f"{rid} has no port rule: "
                             f"{NO_COUNTERPART[rid]}")
    root = root or package_root()
    scans = scan_package(root, package=package, files=files)
    graph = CallGraph(scans)
    relpaths = [s.relpath for s in scans]
    narrowed_scope = scope is not None
    if scope is None:
        scope = default_scope(relpaths) if files is None else \
            set(relpaths)
    ctx = LintContext(graph=graph, scans=graph.scans, scope=scope,
                      root=root)

    active = ALL_RULES
    if rules:
        wanted = []
        for rid in rules:
            rule = rule_by_id(rid)
            if rule is None:
                from .rules import IR_RULES
                raise ValueError(
                    f"unknown rule {rid!r} (have: "
                    f"{', '.join(r.id for r in ALL_RULES + IR_RULES)})")
            wanted.append(rule)
        active = wanted

    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for rule in active:
        for f in rule.run(ctx):
            scan = graph.scans.get(f.relpath)
            if scan is not None and scan.suppressed(f.rule, f.lineno):
                suppressed.append(f)
            else:
                findings.append(f)

    stale_budget: List[BaselineEntry] = []
    unjustified_budget: List[BaselineEntry] = []
    ir_entries_run: List[str] = []
    ir_ids_run: Set[str] = set()
    if ir:
        # lazy on purpose: this is the ONLY place the lint path may
        # import torch, and only under an explicit --ir
        from .ircheck import IR_RULE_IDS, run_ircheck
        ir_rules = [rid for rid in (rules or IR_RULE_IDS)
                    if rid in IR_RULE_IDS]
        if ir_rules:
            ir_result = run_ircheck(rules=ir_rules, entries=ir_entries)
            findings.extend(ir_result.findings)
            stale_budget = ir_result.stale_budget
            unjustified_budget = ir_result.unjustified_budget
            ir_entries_run = ir_result.entries_run
            # staleness of baselined IR findings is only decidable
            # when the full entry table ran
            if not ir_entries:
                ir_ids_run = set(ir_rules)
    assign_ids(findings + suppressed)

    if baseline_path is None:
        cand = default_baseline_path(root)
        baseline_path = cand if os.path.exists(cand) else ""
    entries = load_baseline(baseline_path) if baseline_path else []
    by_fid = {e.fid: e for e in entries}
    kept: List[Finding] = []
    baselined: List[Finding] = []
    seen_fids = set()
    for f in findings:
        seen_fids.add(f.fid)
        (baselined if f.fid in by_fid else kept).append(f)
    # staleness is only decidable for rules that actually ran AND (on
    # an explicitly narrowed run: --changed, fixture slices) files the
    # rules reported over — a slice must not report (or --strict-fail
    # on) baseline entries it could never have re-produced. A FULL run
    # applies no path filter on purpose: an entry whose file was
    # deleted or renamed must still surface as stale, or --strict
    # would let it rot invisibly forever.
    # IR rules are excluded from the AST active set by construction
    # (they live in IR_RULES, not ALL_RULES); their baselined entries
    # only count as stale when the IR pass ran the full table
    active_ids = {r.id for r in active
                  if not getattr(r, "ir_only", False)} | ir_ids_run

    def _fid_path(fid: str) -> str:
        parts = fid.split(":", 2)
        return parts[1] if len(parts) >= 2 else ""

    stale = [e for e in entries
             if e.fid not in seen_fids
             and e.fid.split(":", 1)[0] in active_ids
             and (not narrowed_scope
                  or _fid_path(e.fid) in scope
                  or e.fid.split(":", 1)[0] in ir_ids_run)]
    unjustified = [e for e in entries if not e.justification]
    kept.sort(key=lambda f: f.sort_key())
    baselined.sort(key=lambda f: f.sort_key())
    return LintResult(findings=kept, baselined=baselined,
                      stale_baseline=stale, suppressed=suppressed,
                      files=set(relpaths) & scope, graph=graph,
                      elapsed=time.perf_counter() - t0,
                      unjustified_baseline=unjustified,
                      stale_budget=stale_budget,
                      unjustified_budget=unjustified_budget,
                      ir_entries=ir_entries_run)

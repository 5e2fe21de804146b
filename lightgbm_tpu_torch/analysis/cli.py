"""``python -m lightgbm_tpu_torch lint`` — the port's lint CLI.

The port's copy of ``lightgbm_tpu/analysis/cli.py``, with its flags and
exit codes. Importable (and runnable) WITHOUT torch: the dispatcher in
``lightgbm_tpu_torch/__main__.py`` routes ``lint`` here before the
training CLI (and its torch import) loads, so the analyzer runs where no
torch is installed. Only ``--ir`` imports torch, on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Set

EXIT_CODES = """\
exit codes:
  0  clean: no findings outside the baseline
  1  findings (or stale/unjustified baseline entries with --strict)
  2  usage or internal error
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch lint",
        description=(
            "The port's static analyzer for the boosting hot path and "
            "the distributed layer. Builds a cross-module call graph, "
            "the set of functions a '# tpulint: hot' driver reaches, "
            "and per-function CFGs with rank-taint and lock dataflow, "
            "and checks TPL002, TPL003 and TPL005-TPL010 (host syncs "
            "in hot code, kernel builds and forest uploads in loops, "
            "order-unstable iteration feeding collectives, locks "
            "across device work, rank-divergent collective order, "
            "thread-shared-state races, float64 uploads in hot code, "
            "collectives under rank-local read-back branches) plus "
            "the contract pass TPL015-TPL018 (JSONL event schemas, "
            "metric families, LIGHTGBM_TPU_* env vars and fault kinds "
            "against obs/schemas.py). With --ir it also runs every "
            "register_jit entry at small declared shapes on the CPU "
            "and checks TPL011 (float64 aten ops outside an entry's "
            "declared list), TPL012 (collectives of one tree and aten "
            "ops of one split against analysis/budgets.json) and "
            "TPL014 (max_signatures declared). The JAX package's "
            "TPL001, TPL004 and TPL013 have no port rule."),
        epilog=EXIT_CODES,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text",
                   help="output format (default: text); sarif emits "
                        "SARIF 2.1.0 for code-review tooling")
    p.add_argument("--changed", metavar="REF", nargs="?", const="HEAD",
                   default=None,
                   help="lint only package files differing from git "
                        "REF (default HEAD) — the ~100 ms pre-commit "
                        "mode; with no changed files the analyzer is "
                        "not even constructed")
    p.add_argument("--baseline", metavar="FILE", default=None,
                   help="accepted-findings file (default: "
                        "analysis/baseline.txt when present; "
                        "pass an empty string to disable)")
    p.add_argument("--rule", metavar="TPLNNN", action="append",
                   default=None,
                   help="run only this rule (repeatable); default: "
                        "TPL002, TPL003, TPL005-TPL010 and the "
                        "contract pass TPL015-TPL018 (TPL011, TPL012 "
                        "and TPL014 also need --ir)")
    p.add_argument("--ir", action="store_true",
                   help="also run every register_jit entry at small "
                        "declared shapes on the CPU and check the "
                        "runtime rules TPL011, TPL012 and TPL014; the "
                        "only lint mode that imports torch")
    p.add_argument("--ir-entry", metavar="NAME", action="append",
                   default=None,
                   help="with --ir: run only this entry "
                        "(repeatable; 'ops/grow_tree' or "
                        "'comms/tree@data')")
    p.add_argument("--root", metavar="DIR", default=None,
                   help="package directory to analyze (default: the "
                        "installed lightgbm_tpu_torch package)")
    p.add_argument("--write-baseline", metavar="FILE", default=None,
                   help="write ALL current findings to FILE as a "
                        "baseline skeleton (justifications left as "
                        "TODOs) and exit 0")
    p.add_argument("--strict", action="store_true",
                   help="also fail (exit 1) on stale or unjustified "
                        "baseline entries")
    return p


def changed_relpaths(root: str, ref: str) -> Set[str]:
    """Package-relative paths of ``*.py`` files differing from git
    ``ref`` (committed diffs + working tree + untracked). Raises
    ``ValueError`` when git cannot answer (not a repo, bad ref)."""
    import subprocess
    pkg = os.path.basename(os.path.normpath(root))
    repo = os.path.dirname(os.path.abspath(root))
    out: Set[str] = set()
    # --relative: diff paths come out relative to cwd (the package's
    # parent), not the repo toplevel — required when the package lives
    # below the repo root, and what ls-files already does
    cmds = [
        ["git", "diff", "--relative", "--name-only", ref, "--", pkg],
        ["git", "ls-files", "--others", "--exclude-standard",
         "--", pkg],
    ]
    for cmd in cmds:
        try:
            proc = subprocess.run(cmd, cwd=repo, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.SubprocessError) as e:
            raise ValueError(f"--changed: {' '.join(cmd[:2])} failed "
                             f"({e})")
        if proc.returncode != 0:
            raise ValueError(
                f"--changed: `{' '.join(cmd)}` failed: "
                f"{proc.stderr.strip() or proc.stdout.strip()}")
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.startswith(pkg + "/") and line.endswith(".py"):
                rel = line[len(pkg) + 1:]
                # deleted files have nothing left to lint
                if os.path.exists(os.path.join(root, rel)):
                    out.add(rel)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(
        sys.argv[1:] if argv is None else argv)
    if args.write_baseline and args.rule:
        # a rule-filtered run sees only a slice of the findings;
        # writing it out would silently drop every other rule's
        # accepted entries (and their justifications)
        print("tpulint: error: --write-baseline requires a full run "
              "(drop --rule)", file=sys.stderr)
        return 2
    if args.write_baseline and args.changed is not None:
        print("tpulint: error: --write-baseline requires a full run "
              "(drop --changed)", file=sys.stderr)
        return 2
    if args.ir_entry and not args.ir:
        print("tpulint: error: --ir-entry requires --ir",
              file=sys.stderr)
        return 2
    from .rules import NO_COUNTERPART
    for rid in args.rule or ():
        if rid in NO_COUNTERPART:
            print(f"tpulint: error: {rid} has no port rule: "
                  f"{NO_COUNTERPART[rid]}", file=sys.stderr)
            return 2
    ir_rule_ids = {"TPL011", "TPL012", "TPL014"}
    if args.rule and not args.ir and ir_rule_ids & set(args.rule):
        # keep the contract explicit: the torch import only ever
        # happens under --ir, never because a rule id implied it
        print(f"tpulint: error: "
              f"{', '.join(sorted(ir_rule_ids & set(args.rule)))} "
              f"are IR rules — add --ir", file=sys.stderr)
        return 2
    from .engine import default_scope, package_root, run_lint
    scope = None
    if args.changed is not None:
        root = args.root or package_root()
        try:
            changed = changed_relpaths(root, args.changed)
        except ValueError as e:
            print(f"tpulint: error: {e}", file=sys.stderr)
            return 2
        scope = default_scope(sorted(changed))
        if not scope:
            # the pre-commit fast path: nothing in the rule scope
            # changed, so don't even parse the package
            print(f"tpulint: 0 findings (no files in scope changed "
                  f"vs {args.changed})")
            return 0
    try:
        result = run_lint(root=args.root, rules=args.rule,
                          baseline_path=args.baseline, scope=scope,
                          ir=args.ir, ir_entries=args.ir_entry)
    except (ValueError, OSError, SyntaxError) as e:
        print(f"tpulint: error: {e}", file=sys.stderr)
        return 2
    if args.write_baseline:
        result.write_baseline(args.write_baseline)
        print(f"tpulint: wrote {len(result.findings) + len(result.baselined)} "
              f"entries to {args.write_baseline}")
        return 0
    if args.format == "json":
        from .report import render_json
        print(render_json(result))
    elif args.format == "sarif":
        from .report import render_sarif
        print(render_sarif(result))
    else:
        from .report import render_text
        print(render_text(result))
    if result.findings:
        return 1
    if args.strict and (result.stale_baseline
                        or result.unjustified_baseline
                        or result.stale_budget
                        or result.unjustified_budget):
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

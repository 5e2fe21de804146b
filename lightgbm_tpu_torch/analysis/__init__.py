"""The port's lint: static analysis of the port's own invariants, the
counterpart of ``lightgbm_tpu/analysis/``.

The engine is the JAX package's, copied (it is pure ``ast`` and takes
its package as a parameter), with the port's names as its defaults; the
rules ask what the port can get wrong:

- :mod:`~lightgbm_tpu_torch.analysis.astscan` parses every module of the
  package (pure ``ast`` — importing this package never imports torch),
  with the ``# tpulint:`` pragmas ``hot``, ``disable=``, ``threadsafe``
  and ``replicated-cond``;
- :mod:`~lightgbm_tpu_torch.analysis.callgraph` builds the cross-module
  call graph, and over it the set of functions a ``# tpulint: hot``
  driver (the boosting iteration, the grower's tree and split, the
  serving walk) reaches;
- :mod:`~lightgbm_tpu_torch.analysis.cfg` builds per-function
  control-flow graphs with guard-pin and lock-held dataflow;
  :mod:`~lightgbm_tpu_torch.analysis.dataflow` adds rank taint (the
  port's rank sources), the thread-side closure and float64 producers;
- :mod:`~lightgbm_tpu_torch.analysis.rules` runs the rule set: TPL002
  (host syncs in hot code), TPL003 (kernel builds and forest uploads in
  loops), TPL005, TPL006, the flow rules TPL007-TPL010
  (:mod:`~lightgbm_tpu_torch.analysis.rules_flow`) and the contract pass
  TPL015-TPL018 (:mod:`~lightgbm_tpu_torch.analysis.rules_contract`);
- :mod:`~lightgbm_tpu_torch.analysis.baseline` matches findings against
  the accepted findings in ``analysis/baseline.txt``;
- :mod:`~lightgbm_tpu_torch.analysis.ircheck` (``lint --ir`` only — the
  one mode that imports torch, on the CPU) runs every ``register_jit``
  entry at small declared shapes under a dispatch mode and checks
  TPL011 (float64 aten ops), TPL012 (the collectives of one tree per
  learner mode and the aten ops of one split against
  ``analysis/budgets.json``) and TPL014 (``max_signatures`` declared).

The JAX rules TPL001, TPL004 and TPL013 have no port rule (torch is
eager and has no donation; ROADMAP.md Queue 3).

Entry points: ``python -m lightgbm_tpu_torch lint`` (see
:mod:`~lightgbm_tpu_torch.analysis.cli`) and :func:`run_lint`.
"""

from .callgraph import CallGraph, build_callgraph
from .engine import LintResult, default_scope, package_root, run_lint
from .rules import ALL_RULES, IR_RULES, Finding, rule_by_id

__all__ = [
    "run_lint", "LintResult", "build_callgraph", "CallGraph",
    "Finding", "ALL_RULES", "IR_RULES", "rule_by_id", "default_scope",
    "package_root",
]

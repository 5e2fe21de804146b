"""Runtime lint (``python -m lightgbm_tpu_torch lint --ir``): the port's
counterpart of ``lightgbm_tpu/analysis/ircheck.py``.

The AST rules see source idioms; this pass sees the aten ops the port
really dispatches. The JAX pass lowers every ``register_jit`` entry and
reads its jaxpr; the port has no program to lower, so it RUNS every
registered entry at small declared shapes on the CPU — through the
public API, the drivers of :data:`DRIVERS` — with a ``TorchDispatchMode``
that sees each aten op, and checks three rule families:

- **TPL011 dtype contract** — every aten op with a float64 tensor among
  its inputs or outputs, attributed to the innermost package function on
  the Python stack, must sit in a function its entry declares in
  ``analysis/budgets.json`` (``float64_sites``). The port uses float64
  on purpose in a few places (``ops/split.py`` rounds each gain once
  through float64, the linear leaves fit in float64); anything else is
  a float64 op the card would run at a fraction of float32's rate.
- **TPL012 budgets** — two budgets, pinned in ``analysis/budgets.json``:
  the **collectives of one tree per learner mode** (``parallel/
  dp_grow@data|feature|voting``: the ``Comm`` ledger's calls and bytes
  of rank 0 in a gloo world of two CPU processes), and the **launch
  budget of one split** (``ops/grow_tree@split``: the aten ops one
  ``Grower._split`` dispatches, the most over the splits of one tree,
  with each call of a kernel wrapper counted as the one launch it is on
  the card). The launch budget is the static guard of ROADMAP.md Queue
  2's P1: a split is a few hundred small launches, and one more a split
  fails the lint until the budget is raised with its reason.
- **TPL014 recompile surface** — every ``register_jit`` site declares
  ``max_signatures`` (AST-scanned), and ``serve/predict``'s covers the
  power-of-two buckets ``CompiledForest.warmup`` walks.

The JAX rule TPL013 (donation honored) has no counterpart: torch has no
donation. This module is imported ONLY under ``--ir`` and imports torch
only inside :func:`run_ircheck`, pinned to the CPU (no card is used even
where one is present); attribution (``obs/cost.py``) is off while the
drivers run, so its own dispatch modes never meet this pass's.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .baseline import BaselineEntry
from .rules import Finding

__all__ = ["run_ircheck", "IRCheckResult", "DRIVERS", "WORLD_MODES",
           "default_budgets_path", "load_budgets", "budget_findings",
           "f64_findings", "register_jit_sites",
           "recompile_surface_findings", "measure_entries", "op_census",
           "world_ledgers", "IR_RULE_IDS"]

IR_RULE_IDS = ("TPL011", "TPL012", "TPL014")

#: budget keys TPL012 compares (measured <= committed); any other key
#: in a budget entry is a typo and reported as a finding rather than
#: silently ignored
_BUDGET_METRICS = ("n_collectives", "wire_bytes", "aten_ops_per_split")
_BUDGET_KEYS = _BUDGET_METRICS + ("justification", "float64_sites")

#: the learner modes whose one tree's collectives are budgeted
WORLD_MODES = ("data", "feature", "voting")

_PKG = "lightgbm_tpu_torch"


def default_budgets_path(root: Optional[str] = None) -> str:
    from .engine import package_root
    root = root or package_root()
    return os.path.join(root, "analysis", "budgets.json")


def load_budgets(path: str):
    """Parse ``analysis/budgets.json``.

    Returns ``(entries, unjustified)``: the committed budget dict and
    the :class:`BaselineEntry` list for entries missing a real
    justification (TODO placeholders count as missing — the discipline
    ``analysis/baseline.txt`` keeps)."""
    if not os.path.exists(path):
        return {}, []
    with open(path, encoding="utf-8") as fh:
        raw = json.load(fh)
    entries = raw.get("entries", {})
    unjustified: List[BaselineEntry] = []
    for i, (key, val) in enumerate(sorted(entries.items()), start=1):
        just = str(val.get("justification", "")).strip()
        if not just or just.upper().startswith("TODO"):
            unjustified.append(BaselineEntry(
                fid=f"budgets.json:{key}", justification="", lineno=i))
    return entries, unjustified


# ---------------------------------------------------------------------
# the drivers: each exercises registered entries through the public API
# ---------------------------------------------------------------------

_CPU = {"device_type": "cpu", "verbosity": -1, "seed": 7}


def _data(n: int = 600, F: int = 6, seed: int = 0):
    import numpy as np
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rs.randn(n) > 0).astype(
        np.float64)
    return X, y


def _drive_train():
    """Binary training with a valid set, then raw and leaf predictions
    and a compiled forest: ``ops/grow_tree`` (and its kernels),
    ``gbdt/tree_values_binned``, ``gbdt/tree_leaves_binned``,
    ``prediction/forest_leaves``, ``serve/predict``."""
    import lightgbm_tpu_torch as lgb
    X, y = _data()
    ds = lgb.Dataset(X[:500], label=y[:500], params=_CPU)
    vs = ds.create_valid(X[500:], label=y[500:])
    bst = lgb.train({**_CPU, "objective": "binary", "num_leaves": 15,
                     "min_data_in_leaf": 5}, ds, 2, valid_sets=[vs])
    bst.predict(X[:64])
    bst.predict(X[:64], pred_leaf=True)
    from ..serve.compile import compile_forest
    cf = compile_forest(bst, max_batch_rows=64)
    cf.warmup()
    cf.predict(X[:40])


def _drive_linear():
    """A linear tree: ``gbdt/linear_eval``."""
    import lightgbm_tpu_torch as lgb
    X, y = _data(seed=1)
    ds = lgb.Dataset(X, label=y, params={**_CPU, "linear_tree": True})
    bst = lgb.train({**_CPU, "objective": "regression", "num_leaves": 7,
                     "linear_tree": True, "min_data_in_leaf": 20}, ds, 2)
    bst.predict(X[:64])


def _drive_rank():
    """Lambdarank: ``ranking/lambdarank_grads``."""
    import numpy as np
    import lightgbm_tpu_torch as lgb
    rs = np.random.RandomState(2)
    X = rs.randn(240, 5).astype(np.float32)
    y = rs.randint(0, 4, 240).astype(np.float64)
    ds = lgb.Dataset(X, label=y, group=[40] * 6, params=_CPU)
    lgb.train({**_CPU, "objective": "lambdarank", "num_leaves": 7,
               "min_data_in_leaf": 5}, ds, 1)


#: name -> driver; every registered entry the serial port runs is reached
#: by one of them (``parallel/dp_grow`` runs in :func:`world_ledgers`)
DRIVERS: Dict[str, Callable[[], None]] = {
    "train": _drive_train, "linear": _drive_linear, "rank": _drive_rank}


def _site(pkg_dir: str) -> Tuple[str, int, str]:
    """(relpath, lineno, qualname) of the innermost frame on the stack
    under ``pkg_dir``, outside the analyzer and the attribution proxy."""
    f = sys._getframe(2)
    skip = (os.path.join(pkg_dir, "analysis") + os.sep,
            os.path.join(pkg_dir, "obs", "cost.py"))
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(pkg_dir + os.sep) and not fn.startswith(skip):
            rel = os.path.relpath(fn, pkg_dir).replace(os.sep, "/")
            return rel, f.f_lineno, getattr(f.f_code, "co_qualname",
                                            f.f_code.co_name)
        f = f.f_back
    return "<torch>", 0, "<torch>"


def op_census(fn: Callable, *args, pkg_dir: Optional[str] = None,
              **kwargs) -> Tuple[int, Dict[Tuple[str, str],
                                             Tuple[int, str]]]:
    """(aten ops dispatched, float64 sites ``{(relpath, qualname):
    (lineno, first aten op)}`` under ``pkg_dir``) of one call of
    ``fn`` — the two counts TPL012's launch budget and TPL011 read."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    root = os.path.abspath(pkg_dir or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    n, sites = [0], {}

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            kw = kw or {}
            res = func(*a, **kw)
            n[0] += 1
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64
                   for t in tree_leaves((a, kw, res))):
                rel, line, qual = _site(root)
                sites.setdefault((rel, qual), (line, func.name()))
            return res

    with _Mode():
        fn(*args, **kwargs)
    return n[0], sites


@dataclass
class _Measured:
    """What the drivers dispatched: per entry, the float64 sites
    ``{(relpath, qualname): (lineno, first aten op)}``; per split, the
    aten ops."""
    f64: Dict[str, Dict[Tuple[str, str], Tuple[int, str]]] = field(
        default_factory=dict)
    split_ops: List[int] = field(default_factory=list)
    entries_run: List[str] = field(default_factory=list)


def measure_entries(drivers: Optional[Sequence[str]] = None
                    ) -> _Measured:
    """Run the drivers on the CPU under one dispatch mode and return what
    each registered entry dispatched. The kernel wrappers (K1, K2) count
    as one launch each and are not looked into: their plain versions
    are CPU-only references, not what the card runs."""
    import torch
    from torch.utils._python_dispatch import (TorchDispatchMode,
                                              _disable_current_modes)
    from torch.utils._pytree import tree_leaves

    from ..obs import cost
    from ..ops import grow as grow_mod

    import importlib
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for site in register_jit_sites(pkg_dir):
        # every registered entry is wrapped before the probes go in
        importlib.import_module(
            f"{_PKG}." + site["relpath"][:-3].replace("/", "."))
    out = _Measured()
    stack: List[str] = []
    split_count: List[int] = []

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            res = func(*args, **kwargs)
            if split_count:
                split_count[-1] += 1
            if stack and any(
                    isinstance(t, torch.Tensor)
                    and t.dtype == torch.float64
                    for t in tree_leaves((args, kwargs, res))):
                rel, line, qual = _site(pkg_dir)
                out.f64.setdefault(stack[-1], {}).setdefault(
                    (rel, qual), (line, func.name()))
            return res

    kernels = {"ops/pallas_hist", "ops/partition"}
    saved = []

    def probe(name, fn):
        def run(*args, **kwargs):
            if name in kernels:
                if split_count:
                    split_count[-1] += 1
                with _disable_current_modes():
                    return fn(*args, **kwargs)
            stack.append(name)
            if name not in out.entries_run:
                out.entries_run.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
        return run

    with cost._sig_lock:
        trackers = list(cost._trackers)
    for t in trackers:
        saved.append((t, t._fn))
        object.__setattr__(t, "_fn", probe(t._name, t._fn))
    split = grow_mod.Grower._split

    def counted_split(self, *args, **kwargs):
        split_count.append(0)
        try:
            return split(self, *args, **kwargs)
        finally:
            out.split_ops.append(split_count.pop())

    grow_mod.Grower._split = counted_split
    env = os.environ.get("LIGHTGBM_TPU_COST_ATTRIBUTION")
    os.environ["LIGHTGBM_TPU_COST_ATTRIBUTION"] = "0"
    try:
        with _Mode():
            for name in (drivers or DRIVERS):
                DRIVERS[name]()
    finally:
        grow_mod.Grower._split = split
        for t, fn in saved:
            object.__setattr__(t, "_fn", fn)
        if env is None:
            os.environ.pop("LIGHTGBM_TPU_COST_ATTRIBUTION", None)
        else:
            os.environ["LIGHTGBM_TPU_COST_ATTRIBUTION"] = env
    return out


# ---------------------------------------------------------------------
# the world: one tree per learner mode in a gloo world of two processes
# ---------------------------------------------------------------------

def _world_worker(out_path: str) -> None:
    """One rank: a tree per mode of :data:`WORLD_MODES` on the same
    seeded rows; rank 0 writes each tree's ``Comm`` ledger."""
    import lightgbm_tpu_torch as lgb
    from ..parallel import distributed
    from ..parallel.mesh import world_rank
    distributed.init_distributed(device_type="cpu")
    X, y = _data(n=800, F=8, seed=3)
    ledgers = {}
    for mode in WORLD_MODES:
        ds = lgb.Dataset(X, label=y, params=_CPU)
        bst = lgb.train({**_CPU, "objective": "binary", "num_leaves": 7,
                         "min_data_in_leaf": 5, "tree_learner": mode,
                         "top_k": 3}, ds, 1)
        comm = bst._engine.comm
        ledgers[mode] = {"n_collectives": sum(comm.calls.values()),
                         "wire_bytes": sum(comm.bytes.values()),
                         "calls": dict(sorted(comm.calls.items()))}
    if world_rank() == 0:
        with open(out_path, "w") as fh:
            json.dump(ledgers, fh)
    distributed.shutdown_distributed()


def world_ledgers(timeout: float = 300.0) -> Dict[str, dict]:
    """The ``Comm`` ledger of one tree per learner mode, from rank 0 of
    a gloo world of two CPU processes."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as td:
        out_path = os.path.join(td, "ledgers.json")
        procs = []
        for rank in range(2):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("LIGHTGBM_TPU_")}
            env.update(LIGHTGBM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       LIGHTGBM_TPU_NUM_PROCS="2",
                       LIGHTGBM_TPU_RANK=str(rank),
                       CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
                       PYTHONPATH=os.pathsep.join(
                           [pkg_parent, env.get("PYTHONPATH", "")]))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", f"{_PKG}.analysis.ircheck",
                 "--world-worker", out_path], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs) or not os.path.exists(
                out_path):
            tail = b"".join(logs)[-2000:].decode(errors="replace")
            raise RuntimeError(f"the lint's world of two failed:\n{tail}")
        with open(out_path) as fh:
            return json.load(fh)


# ---------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------

def f64_findings(measured: _Measured, budgets: dict) -> List[Finding]:
    """TPL011: float64 sites outside their entry's declared list."""
    out = []
    for entry in sorted(measured.f64):
        declared = set(budgets.get(f"{entry}@default", {}).get(
            "float64_sites", []))
        for (rel, qual), (line, op) in sorted(measured.f64[entry].items()):
            if f"{rel}:{qual}" in declared:
                continue
            out.append(Finding(
                rule="TPL011", relpath=rel, lineno=line, col=0,
                func=qual, symbol=f"f64:{entry}",
                message=(f"float64 aten op {op} in {qual}() under entry "
                         f"{entry}: the card runs float64 at a fraction "
                         f"of float32's rate. Build the value float32, "
                         f"or declare '{rel}:{qual}' in the entry's "
                         f"float64_sites in analysis/budgets.json with "
                         f"its reason")))
    return out


def budget_findings(measured: dict, budget: Optional[dict], key: str,
                    relpath: str, func: str) -> List[Finding]:
    """TPL012: measured metrics against one committed budget entry."""
    def f(message):
        return Finding(rule="TPL012", relpath=relpath, lineno=0, col=0,
                       func=func, symbol=f"budget:{key}",
                       message=message)

    shown = {k: v for k, v in measured.items() if k in _BUDGET_METRICS}
    if budget is None:
        return [f(f"{key} has no entry in analysis/budgets.json — "
                  f"measured {json.dumps(shown, sort_keys=True)}; commit "
                  f"it with a justification")]
    out = []
    unknown = sorted(set(budget) - set(_BUDGET_KEYS))
    if unknown:
        out.append(f(f"{key}: unknown budget keys {unknown} (have: "
                     f"{', '.join(_BUDGET_KEYS)})"))
    for metric in _BUDGET_METRICS:
        if metric not in budget or metric not in measured:
            continue
        if measured[metric] > budget[metric]:
            out.append(f(f"{key}: {metric} {measured[metric]} over its "
                         f"budget {budget[metric]} — raise the budget in "
                         f"analysis/budgets.json with the reason, or "
                         f"take the extra work out"))
    return out


def register_jit_sites(pkg_root: str) -> List[dict]:
    """AST scan for ``register_jit(...)`` call sites in the package:
    ``{"relpath", "lineno", "func", "name", "declared"}`` per site."""
    sites = []
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in ("__pycache__", "analysis")]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, pkg_root).replace(os.sep, "/")
            try:
                with open(path, encoding="utf-8") as fh:
                    tree = ast.parse(fh.read(), filename=rel)
            except SyntaxError:
                continue
            funcs = [(n.lineno, getattr(n, "end_lineno", n.lineno),
                      n.name) for n in ast.walk(tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                callee = node.func
                name = callee.attr if isinstance(callee, ast.Attribute) \
                    else getattr(callee, "id", "")
                if name != "register_jit":
                    continue
                entry = ""
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    entry = node.args[0].value
                enclosing, best = "<module>", None
                for lo, hi, fn_name in funcs:
                    if lo <= node.lineno <= hi and \
                            (best is None or hi - lo < best):
                        enclosing, best = fn_name, hi - lo
                sites.append({"relpath": rel, "lineno": node.lineno,
                              "func": enclosing, "name": entry,
                              "declared": any(k.arg == "max_signatures"
                                              for k in node.keywords)})
    return sites


def recompile_surface_findings(pkg_root: str) -> List[Finding]:
    """TPL014: undeclared ``register_jit`` sites, and a ``serve/predict``
    declaration below the warmup's power-of-two buckets."""
    out = []
    for site in register_jit_sites(pkg_root):
        if site["declared"]:
            continue
        out.append(Finding(
            rule="TPL014", relpath=site["relpath"],
            lineno=site["lineno"], col=0, func=site["func"],
            symbol="ir-sigs",
            message=(f"register_jit({site['name']!r}) declares no "
                     f"max_signatures — every entry must commit the "
                     f"number of call signatures it may see, so "
                     f"attribution and lint can flag a storm of new "
                     f"ones against it")))
    from ..obs.jit_tracker import jit_declarations
    from ..serve.compile import n_serve_buckets
    declared = jit_declarations().get("serve/predict")
    buckets = n_serve_buckets()
    if declared is not None and declared < buckets:
        out.append(Finding(
            rule="TPL014", relpath="serve/compile.py", lineno=1, col=0,
            func="CompiledForest._walk", symbol="ir-sigs",
            message=(f"serve/predict declares max_signatures={declared} "
                     f"but CompiledForest.warmup walks {buckets} "
                     f"power-of-two buckets — the warmup alone overruns "
                     f"the declaration")))
    return out


# ---------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------

@dataclass
class IRCheckResult:
    findings: List[Finding]
    stale_budget: List[BaselineEntry] = field(default_factory=list)
    unjustified_budget: List[BaselineEntry] = field(default_factory=list)
    entries_run: List[str] = field(default_factory=list)
    elapsed: float = 0.0


def _all_budget_keys(entries: Sequence[str]) -> List[str]:
    return [f"{e}@default" for e in entries] + ["ops/grow_tree@split"] \
        + [f"parallel/dp_grow@{m}" for m in WORLD_MODES]


def run_ircheck(rules: Optional[Sequence[str]] = None,
                entries: Optional[Sequence[str]] = None,
                budgets_path: Optional[str] = None) -> IRCheckResult:
    """Run the drivers (and, for TPL012, the world of two) and the
    runtime rules. ``rules`` filters to a subset of :data:`IR_RULE_IDS`;
    ``entries`` to registry names (``ops/grow_tree``) or budget keys
    (``parallel/dp_grow@voting``). Returns raw findings (fids are
    assigned by the engine alongside the AST findings)."""
    t0 = time.perf_counter()
    want = set(rules) & set(IR_RULE_IDS) if rules else set(IR_RULE_IDS)
    if "torch" not in sys.modules:
        # pinned to the CPU: the lint never takes a card
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    budgets_path = budgets_path or default_budgets_path()
    budgets, unjustified = load_budgets(budgets_path)

    def wanted(key: str) -> bool:
        return not entries or key in entries \
            or key.split("@", 1)[0] in entries

    findings: List[Finding] = []
    run: List[str] = []
    measured = measure_entries() if want & {"TPL011", "TPL012"} \
        else _Measured()
    if entries and not any(wanted(k) for k in _all_budget_keys(
            measured.entries_run) + list(measured.entries_run)):
        raise ValueError(f"--ir-entry matched nothing (have: "
                         f"{', '.join(_all_budget_keys(measured.entries_run))})")
    if "TPL011" in want:
        keep = {e: v for e, v in measured.f64.items() if wanted(e)}
        findings.extend(f64_findings(_Measured(f64=keep), budgets))
        run += [f"{e}@default" for e in measured.entries_run
                if wanted(e)]
    if "TPL012" in want:
        key = "ops/grow_tree@split"
        if wanted(key):
            findings.extend(budget_findings(
                {"aten_ops_per_split": max(measured.split_ops, default=0)},
                budgets.get(key), key, "ops/grow.py", "Grower._split"))
            run.append(key)
        modes = [m for m in WORLD_MODES
                 if wanted(f"parallel/dp_grow@{m}")]
        if modes:
            ledgers = world_ledgers()
            for m in modes:
                key = f"parallel/dp_grow@{m}"
                findings.extend(budget_findings(
                    ledgers[m], budgets.get(key), key,
                    "parallel/comms.py", "Comm._run"))
                run.append(key)
    if "TPL014" in want and not entries:
        from .engine import package_root
        findings.extend(recompile_surface_findings(package_root()))

    # budget-file staleness mirrors the baseline discipline: a key no
    # driver runs anymore must be deleted, not rot as false assurance
    stale = []
    if not entries and want == set(IR_RULE_IDS):
        known = set(_all_budget_keys(measured.entries_run))
        stale = [BaselineEntry(fid=f"budgets.json:{key}",
                               justification="", lineno=i)
                 for i, key in enumerate(sorted(set(budgets) - known),
                                         start=1)]
    return IRCheckResult(findings=findings, stale_budget=stale,
                         unjustified_budget=unjustified,
                         entries_run=sorted(set(run)),
                         elapsed=time.perf_counter() - t0)


if __name__ == "__main__":  # the world's ranks (world_ledgers)
    if len(sys.argv) == 3 and sys.argv[1] == "--world-worker":
        _world_worker(sys.argv[2])

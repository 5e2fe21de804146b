"""The port's rule set: the counterpart of
``lightgbm_tpu/analysis/rules.py``. Pure stdlib.

Each rule is a class with a stable ``id``, a one-line ``title``, and a
``run(ctx)`` generator yielding :class:`Finding`. Rules see the whole
:class:`~lightgbm_tpu_torch.analysis.callgraph.CallGraph` (hot-
reachability, call records) plus the raw ASTs, and are scoped by the
engine. The statement-level rules live here:

- **TPL002** a host sync (a read-back or a device wait) in a function a
  ``# tpulint: hot`` driver reaches — the static guard of the grower's
  one read-back a split (ROADMAP.md Queue 2, P1);
- **TPL003** the port's recompile surface: a kernel library built or
  loaded, or a compiled forest built, in a loop or in hot code;
- **TPL005** set order feeding the order of the port's collectives;
- **TPL006** a lock held across device work in ``obs/``,
  ``resilience/``, ``serve/`` and ``pipeline.py``.

The flow rules TPL007-TPL010 live in
:mod:`~lightgbm_tpu_torch.analysis.rules_flow`, the contract rules
TPL015-TPL018 in :mod:`~lightgbm_tpu_torch.analysis.rules_contract`;
both are registered into ``ALL_RULES`` below. The JAX rules TPL001
(eager ``lax`` loops), TPL004 (use after donation) and TPL013 (donation
honored) have no counterpart: torch is eager by design and has no
donation (:data:`NO_COUNTERPART`).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .astscan import ModuleScan, dotted_of
from .callgraph import CallGraph, CallRecord, Key

__all__ = ["Finding", "Rule", "ALL_RULES", "IR_RULES", "rule_by_id",
           "LintContext", "NO_COUNTERPART", "TensorTyping"]

#: the JAX package's rules that have no port rule, with where ROADMAP.md
#: says why (``--rule`` with one of them exits 2 naming it)
NO_COUNTERPART = {
    "TPL001": "ROADMAP.md Queue 3, 'The JAX package's TPL001, TPL004 and "
              "TPL013 have no port rule': torch is eager by design, so "
              "there is no eager lax loop to catch",
    "TPL004": "ROADMAP.md Queue 3, 'The JAX package's TPL001, TPL004 and "
              "TPL013 have no port rule': torch has no buffer donation",
    "TPL013": "ROADMAP.md Queue 3, 'The JAX package's TPL001, TPL004 and "
              "TPL013 have no port rule': torch has no buffer donation",
}


@dataclass
class Finding:
    rule: str
    relpath: str
    lineno: int
    col: int
    func: str              # enclosing qualname or "<module>"
    symbol: str            # what was matched (feeds the stable id)
    message: str
    fid: str = ""          # assigned by the engine (stable id)

    def sort_key(self):
        return (self.relpath, self.lineno, self.col, self.rule)


@dataclass
class LintContext:
    graph: CallGraph
    scans: Dict[str, ModuleScan]
    scope: Set[str]                      # relpaths the rules run over
    root: str = ""                       # package dir

    def scoped_scans(self) -> Iterator[ModuleScan]:
        for rel in sorted(self.scope):
            if rel in self.scans:
                yield self.scans[rel]

    def scope_of_node(self, scan: ModuleScan, lineno: int) -> str:
        """Innermost enclosing function qualname for a line."""
        best = "<module>"
        best_span = None
        for qual, info in scan.funcs.items():
            if info.lineno <= lineno <= info.end_lineno:
                span = info.end_lineno - info.lineno
                if best_span is None or span <= best_span:
                    best, best_span = qual, span
        return best

    def is_traced(self, key: Optional[Key]) -> bool:
        return key is not None and key in self.graph.jit_reachable

    def is_hot(self, key: Optional[Key]) -> bool:
        """Does a ``# tpulint: hot`` driver reach this function?"""
        return key is not None and key in self.graph.hot_reachable


class Rule:
    id = "TPL000"
    title = "abstract rule"

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        raise NotImplementedError

    def _finding(self, ctx: LintContext, relpath: str, node,
                 symbol: str, message: str,
                 func: Optional[str] = None) -> Finding:
        scan = ctx.scans[relpath]
        qual = func if func is not None \
            else ctx.scope_of_node(scan, node.lineno)
        return Finding(rule=self.id, relpath=relpath,
                       lineno=node.lineno, col=node.col_offset,
                       func=qual, symbol=symbol, message=message)


# ---------------------------------------------------------------------
class TensorTyping:
    """Which expressions of one function are torch tensors, as far as the
    source says: a ``torch.*`` call, a method call or an index on a
    tensor, arithmetic with one, a local assigned from one, a parameter
    annotated ``torch.Tensor``, a ``self`` attribute some method of the
    class assigns a tensor to, and a call of a package function
    annotated to return one. Anything else (numpy arrays, host scalars,
    untyped objects) is not a tensor: the rules that need a type stay
    silent on it rather than guess."""

    #: tensor methods whose result is not a tensor
    _HOST_METHODS = {"item", "tolist", "numpy", "size", "dim",
                     "numel", "element_size", "data_ptr", "stride",
                     "is_contiguous", "storage_offset", "nelement",
                     "get_device", "__len__"}

    def __init__(self, graph: CallGraph, scan: ModuleScan, info,
                 class_attrs: Set[str], tensor_fns: Set[Key]):
        self.graph = graph
        self.scan = scan
        self.info = info
        self.class_attrs = class_attrs
        self.tensor_fns = tensor_fns
        facts = graph.facts.get(info.key)
        self.records = {id(r.node): r for r in facts.records} \
            if facts is not None else {}
        self.names: Set[str] = set()
        a = info.node.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if _is_tensor_annotation(p.annotation):
                self.names.add(p.arg)
        assigns = [s for s in ast.walk(info.node)
                   if isinstance(s, (ast.Assign, ast.AnnAssign))
                   and getattr(s, "value", None) is not None]
        for _ in range(len(assigns) + 1):
            grew = False
            for s in assigns:
                targets = s.targets if isinstance(s, ast.Assign) \
                    else [s.target]
                if not self.is_tensor(s.value):
                    continue
                for t in targets:
                    for sub in (t.elts if isinstance(t, (ast.Tuple,
                                                         ast.List))
                                else [t]):
                        if isinstance(sub, ast.Name) \
                                and sub.id not in self.names:
                            self.names.add(sub.id)
                            grew = True
            if not grew:
                break

    def _torch_rooted(self, dotted: Optional[str]) -> bool:
        if not dotted:
            return False
        root = dotted.split(".", 1)[0]
        return self.scan.imports.get(root, root).split(".", 1)[0] \
            == "torch"

    def is_tensor(self, node: Optional[ast.AST]) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) \
                    and node.value.id in ("self", "cls"):
                return node.attr in self.class_attrs
            return node.attr == "T" and self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) and self.is_tensor(node.orelse)
        if isinstance(node, ast.Call):
            f = node.func
            d = dotted_of(f)
            if self._torch_rooted(d):
                tail = d.rsplit(".", 1)[-1]
                return tail not in ("device", "dtype", "Generator",
                                    "no_grad", "inference_mode",
                                    "is_tensor", "get_device_name",
                                    "synchronize", "current_device",
                                    "device_count", "is_available")
            if isinstance(f, ast.Attribute) \
                    and f.attr not in self._HOST_METHODS \
                    and self.is_tensor(f.value):
                return True
            rec = self.records.get(id(node))
            if rec is not None and rec.kind == "known" \
                    and rec.target in self.tensor_fns:
                return True
        return False


def _is_tensor_annotation(ann) -> bool:
    d = dotted_of(ann) if ann is not None else None
    if d is None and isinstance(ann, ast.Constant) \
            and isinstance(ann.value, str):
        d = ann.value
    return bool(d) and d.rsplit(".", 1)[-1] == "Tensor"


def tensor_context(graph: CallGraph):
    """(class attrs per (relpath, class), package functions annotated to
    return a tensor) — the package-wide half of :class:`TensorTyping`."""
    tensor_fns = {k for k, f in graph.funcs.items()
                  if _is_tensor_annotation(getattr(f.node, "returns",
                                                   None))}
    attrs: Dict[Tuple[str, str], Set[str]] = {}
    for scan in graph.scans.values():
        for info in scan.funcs.values():
            if info.class_name is None:
                continue
            cls_attrs = attrs.setdefault((scan.relpath, info.class_name),
                                         set())
            typing = None
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        if typing is None:
                            typing = TensorTyping(graph, scan, info,
                                                  set(), tensor_fns)
                        if typing.is_tensor(node.value):
                            cls_attrs.add(t.attr)
    return attrs, tensor_fns


# ---------------------------------------------------------------------
class HostSync(Rule):
    """TPL002: a host sync in a function a ``# tpulint: hot`` driver
    reaches: ``.item()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
    ``torch.cuda.synchronize``, and on a tensor ``.tolist()``,
    ``int/float/bool(...)`` and ``np.asarray/np.array(...)``. Each waits
    for the card to drain its queue, so the host cannot run ahead of it
    (ROADMAP.md Queue 2, P1). The grower's counted read-back channel,
    ``Grower._host`` (one a split, counted in ``Grower.readbacks``), is
    the one exempt path: every other read-back in the loop is a
    finding, baselined only with its reason."""

    id = "TPL002"
    title = "host sync in code a per-iteration hot driver reaches"

    #: the counted read-back channel of the growth loop
    EXEMPT = {("ops/grow.py", "Grower._host")}
    _ALWAYS = {"item", "cpu", "numpy"}
    _SYNC_NUMPY = {"numpy.asarray": "np.asarray", "numpy.array": "np.array"}

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        attrs = tensors = None
        for scope, facts in ctx.graph.facts.items():
            if scope is None or not ctx.is_hot(scope) \
                    or scope in self.EXEMPT or scope[0] not in ctx.scope:
                continue
            if attrs is None:
                attrs, tensors = tensor_context(ctx.graph)
            info = ctx.graph.funcs[scope]
            scan = ctx.scans[scope[0]]
            typing = None
            for rec in facts.records:
                sym = self._sync_symbol(rec)
                if sym is None:
                    if not self._needs_type(rec):
                        continue
                    if typing is None:
                        typing = TensorTyping(
                            ctx.graph, scan, info,
                            attrs.get((scan.relpath, info.class_name),
                                      set()), tensors)
                    sym = self._typed_symbol(rec, typing)
                    if sym is None:
                        continue
                yield self._finding(
                    ctx, rec.relpath, rec.node, sym,
                    f"{sym} in {scope[1]}(), which a per-iteration hot "
                    "driver reaches: it waits for the card to drain its "
                    "queue, so the host stops running ahead of it "
                    "(ROADMAP.md Queue 2, P1). Keep the value on the "
                    "device, fold it into the split's one read-back "
                    "(Grower._host), or baseline it with its reason.",
                    func=scope[1])

    def _sync_symbol(self, rec: CallRecord) -> Optional[str]:
        if rec.kind == "method" and rec.attr in self._ALWAYS:
            return f".{rec.attr}()"
        if rec.kind == "method" and rec.attr == "to":
            args = list(rec.node.args) + [kw.value for kw in
                                          rec.node.keywords
                                          if kw.arg == "device"]
            if any(isinstance(a, ast.Constant) and a.value == "cpu"
                   for a in args):
                return '.to("cpu")'
        if rec.kind in ("ext", "known") and (rec.dotted or "").endswith(
                "cuda.synchronize"):
            return "torch.cuda.synchronize"
        return None

    def _needs_type(self, rec: CallRecord) -> bool:
        return (rec.kind == "method" and rec.attr == "tolist") \
            or (rec.kind == "builtin"
                and rec.dotted in ("int", "float", "bool")) \
            or (rec.kind == "ext" and rec.dotted in self._SYNC_NUMPY)

    def _typed_symbol(self, rec: CallRecord,
                      typing: TensorTyping) -> Optional[str]:
        node = rec.node
        if rec.kind == "method":
            return ".tolist()" if typing.is_tensor(node.func.value) \
                else None
        if not node.args or not typing.is_tensor(node.args[0]):
            return None
        if rec.kind == "builtin":
            return f"{rec.dotted}()"
        return self._SYNC_NUMPY[rec.dotted]


# ---------------------------------------------------------------------
class RecompileHazard(Rule):
    """TPL003: the port's recompile surface. A kernel library is built
    by ``nvcc`` and loaded at first use (``ops/_cuda.py`` ``build`` /
    ``library``), and a compiled forest uploads and stacks its trees
    when built (``serve/compile.py`` ``CompiledForest``,
    ``compile_forest``). Either one in a loop, or in code a hot driver
    reaches, is a build or an upload per pass unless it is memoized —
    the JAX package's jit-in-a-loop class."""

    id = "TPL003"
    title = "kernel build/load or compiled forest in a loop or hot code"

    _CUDA = {"build", "library"}
    _FOREST = {"CompiledForest", "compile_forest"}

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for scope, facts in ctx.graph.facts.items():
            hot = ctx.is_hot(scope)
            for rec in facts.records:
                if rec.relpath not in ctx.scope:
                    continue
                if not (rec.in_loop or hot):
                    continue
                what = self._surface(ctx, rec)
                if what is None:
                    continue
                where = "inside a loop" if rec.in_loop else \
                    "in code a per-iteration hot driver reaches"
                yield self._finding(
                    ctx, rec.relpath, rec.node, f"recompile:{what}",
                    f"{what} {where}: a kernel build (nvcc) or a "
                    "forest's upload per pass unless it is memoized — "
                    "the recompile class jit_tracker's RecompileWatcher "
                    "counts. Hoist it to set-up, or baseline it with "
                    "the memo that makes it free.",
                    func=scope[1] if scope else "<module>")

    def _surface(self, ctx: LintContext, rec: CallRecord) -> Optional[str]:
        if rec.kind == "known" and rec.target is not None:
            base = rec.target[1].rsplit(".", 1)[-1]
            if rec.target[0] == "ops/_cuda.py" and base in self._CUDA:
                return f"_cuda.{base}"
            if base in self._FOREST:
                return base
        if rec.kind == "ext" and rec.dotted:
            parts = rec.dotted.split(".")
            if parts[-1] in self._CUDA and "_cuda" in parts:
                return f"_cuda.{parts[-1]}"
            if parts[-1] in self._FOREST:
                return parts[-1]
        if rec.kind == "builtin" and rec.dotted in self._FOREST:
            return rec.dotted
        return None


# ---------------------------------------------------------------------
class UnorderedIteration(Rule):
    """TPL005: iteration over a ``set`` (or hash-ordered view) where the
    order feeds the order of the port's collectives
    (``torch.distributed.*``, the ``Comm`` methods of
    ``parallel/comms.py``, ``parallel/hostsync.py``). Set order varies
    with PYTHONHASHSEED and across processes — each rank would join its
    collectives in a different order (silent divergence or deadlock).
    Checked in ``parallel/``, in hot code and in every function that
    reaches a collective."""

    id = "TPL005"
    title = "order-unstable set/dict iteration feeding collective order"

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        from .rules_flow import CollectiveOrder
        reaches = CollectiveOrder._reaches_collective(ctx.graph)
        for scan in ctx.scoped_scans():
            in_parallel = scan.relpath.startswith("parallel/")
            for qual, info in scan.funcs.items():
                key = info.key
                relevant = (ctx.is_hot(key) or in_parallel
                            or key in reaches)
                if not relevant:
                    continue
                yield from self._check_function(ctx, scan, qual, info)

    def _set_assigns(self, fn_node) -> Dict[str, List[Tuple[int, bool]]]:
        """Per-variable assignment history: (lineno, assigned-a-set).
        Lookups are by line so ``s = {...}; use(s); s = sorted(s)``
        stays precise in straight-line code."""
        out: Dict[str, List[Tuple[int, bool]]] = {}
        for sub in ast.walk(fn_node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                out.setdefault(sub.targets[0].id, []).append(
                    (sub.lineno, self._is_set_expr(sub.value)))
        for hist in out.values():
            hist.sort()
        return out

    @staticmethod
    def _is_set_expr(node) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("set", "frozenset"):
            return True
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.Sub)):
            return UnorderedIteration._is_set_expr(node.left) \
                or UnorderedIteration._is_set_expr(node.right)
        return False

    def _check_function(self, ctx, scan, qual, info):
        assigns = self._set_assigns(info.node)

        def is_set(node):
            if self._is_set_expr(node):
                return True
            if not isinstance(node, ast.Name):
                return False
            last = None
            for lineno, was_set in assigns.get(node.id, ()):
                if lineno >= node.lineno:
                    break
                last = was_set
            return bool(last)

        for sub in ast.walk(info.node):
            it = None
            how = None
            if isinstance(sub, (ast.For, ast.AsyncFor)):
                it, how, node = sub.iter, "for-loop", sub.iter
            elif isinstance(sub, (ast.ListComp, ast.SetComp,
                                  ast.GeneratorExp, ast.DictComp)):
                it, how, node = sub.generators[0].iter, \
                    "comprehension", sub.generators[0].iter
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Name) \
                    and sub.func.id == "sorted" and sub.args \
                    and is_set(sub.args[0]) \
                    and any(kw.arg == "key" for kw in sub.keywords):
                nm = self._describe(sub.args[0])
                yield self._finding(
                    ctx, scan.relpath, sub, f"set-sorted-key:{nm}",
                    f"sorted({nm}, key=...) over a set: the sort is "
                    "stable, so elements with EQUAL keys keep the "
                    "set's hash order — which varies per process "
                    "(PYTHONHASHSEED) and can diverge across SPMD "
                    "ranks. Build a list (deterministic order) before "
                    "sorting, or sort without ties.", func=qual)
                continue
            if it is None or not is_set(it):
                continue
            yield self._finding(
                ctx, scan.relpath, node,
                f"set-iteration:{self._describe(it)}",
                f"{how} over a set ({self._describe(it)}): set order "
                "varies with PYTHONHASHSEED and across processes. If "
                "it feeds collective order, the world's ranks diverge "
                "silently (the step check of parallel/spmd.py turns "
                "that into an error). Iterate sorted(...) or a list "
                "instead.", func=qual)

    @staticmethod
    def _describe(node) -> str:
        d = dotted_of(node)
        if d:
            return d
        return node.__class__.__name__.lower()


# ---------------------------------------------------------------------
class LockAcrossDispatch(Rule):
    """TPL006: a ``threading`` lock held across device work in the
    observability, resilience or serving layer: a ``torch.*`` call, a
    copy to or from the card (``.to(device)``, ``.cpu()``, ``.item()``),
    a kernel wrapper or any package function that reaches one, or a
    collective. Device work can block on the card; holding a telemetry
    lock across it turns a metrics read on another thread into a
    pipeline stall. In ``resilience/`` the collective watchdog's
    bookkeeping lock held across a collective would hang the abort path
    that exists to break hangs (copy-under-lock, sync-outside); in
    ``serve/`` the micro-batcher's lock held across the walk would stall
    every submit()/stats() caller behind one slow device batch."""

    id = "TPL006"
    title = "lock held across device work in obs/, resilience/, " \
            "serve/ or pipeline.py"

    _SCOPE_PREFIXES = ("obs/", "resilience/", "serve/", "pipeline")
    _LOCK_CALLS = {"Lock", "RLock", "Condition", "Semaphore"}

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for scan in ctx.scoped_scans():
            if not scan.relpath.startswith(self._SCOPE_PREFIXES):
                continue
            for qual, info in scan.funcs.items():
                yield from self._check_function(ctx, scan, qual, info)

    def _looks_like_lock(self, node) -> bool:
        d = dotted_of(node)
        if d is None:
            if isinstance(node, ast.Call):
                f = dotted_of(node.func) or ""
                return f.rsplit(".", 1)[-1] in self._LOCK_CALLS
            return False
        last = d.rsplit(".", 1)[-1].lower()
        return "lock" in last or "mutex" in last

    def _check_function(self, ctx, scan, qual, info):
        facts = ctx.graph.facts.get(info.key)
        if facts is None:
            return
        for sub in ast.walk(info.node):
            if not isinstance(sub, (ast.With, ast.AsyncWith)):
                continue
            if not any(self._looks_like_lock(item.context_expr)
                       for item in sub.items):
                continue
            lo = sub.lineno
            hi = getattr(sub, "end_lineno", lo)
            for rec in facts.records:
                if not (lo <= rec.node.lineno <= hi):
                    continue
                if ctx.graph.record_dispatches(rec):
                    what = rec.dotted or (
                        f".{rec.attr}()" if rec.attr else "call")
                    yield self._finding(
                        ctx, scan.relpath, rec.node,
                        f"lock-dispatch:{what}",
                        f"device work ({what}) while holding a lock "
                        f"(with-block at line {lo}): dispatch can "
                        "block on the device, so every other thread "
                        "touching this lock (telemetry snapshots, "
                        "callbacks) stalls with it — and a re-entrant "
                        "path deadlocks. Copy state under the lock, "
                        "dispatch outside it.", func=qual)
                    break


#: imported at the bottom on purpose: rules_flow/rules_contract
#: subclass Rule/use Finding, so they need this module's upper half to
#: exist first. Import THIS module (or the package) for the full rule
#: set.
from .rules_flow import FLOW_RULES  # noqa: E402
from .rules_contract import CONTRACT_RULES  # noqa: E402

ALL_RULES: List[Rule] = [HostSync(), RecompileHazard(),
                         UnorderedIteration(), LockAcrossDispatch(),
                         *FLOW_RULES, *CONTRACT_RULES]


# ---------------------------------------------------------------------
# IR-contract rules (TPL011, TPL012, TPL014): descriptors only. The
# checks run in analysis/ircheck.py under ``lint --ir`` — the ONE path
# that imports torch — by running every registered entry at small
# declared shapes on the CPU. They are deliberately NOT in ALL_RULES:
# the default pass stays torch-free.
# ---------------------------------------------------------------------

class IRRule(Rule):
    """Base for the runtime rules. ``run`` never yields — findings come
    from :mod:`~lightgbm_tpu_torch.analysis.ircheck`."""

    ir_only = True

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        return iter(())


class DtypeContractIR(IRRule):
    id = "TPL011"
    title = ("float64 aten op in a registered entry outside the entry's "
             "declared float64 list")


class CollectiveBudgetIR(IRRule):
    id = "TPL012"
    title = ("collectives of one tree per learner mode, or aten ops of "
             "one split, over the committed analysis/budgets.json "
             "budget (or without one)")


class RecompileSurfaceIR(IRRule):
    id = "TPL014"
    title = ("register_jit entry without a declared max_signatures "
             "(or serve/predict's below the power-of-two buckets)")


IR_RULES: List[Rule] = [DtypeContractIR(), CollectiveBudgetIR(),
                        RecompileSurfaceIR()]


def rule_by_id(rid: str) -> Optional[Rule]:
    for r in ALL_RULES + IR_RULES:
        if r.id == rid:
            return r
    return None

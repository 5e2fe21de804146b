"""Flow-sensitive rules TPL007-TPL010 (CFG + dataflow based): the
port's counterpart of ``lightgbm_tpu/analysis/rules_flow.py``.

These rules sit on top of :mod:`~lightgbm_tpu_torch.analysis.cfg` (per-
function control-flow graphs with guard-pin and lock dataflow) and
:mod:`~lightgbm_tpu_torch.analysis.dataflow` (rank taint, thread-side
closure, float64 producers), where TPL002-TPL006 are per-statement.
TPL007 and TPL008 are the JAX package's rules over the port's
collectives (``dataflow.PORT_COLLECTIVES``) and rank sources; TPL009
asks of a float64 upload in hot code what the JAX rule asks of a value
entering jit, and TPL010 of a collective under a rank-local read-back
what the JAX rule asks of one under ``lax.cond``.

Imported by :mod:`~lightgbm_tpu_torch.analysis.rules` (which owns
``ALL_RULES``); import that module, not this one, to get the full rule
set.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .astscan import ModuleScan, dotted_of
from .callgraph import CallGraph, CallRecord, Key
from .cfg import FunctionCFG
from .dataflow import (MUTATOR_METHODS, PORT_COLLECTIVES,
                       SYNC_PRIMITIVE_CTORS, RankTaint, is_float64_expr,
                       rank_tainted_returns, thread_side_functions)
from .rules import Finding, LintContext, Rule

__all__ = ["CollectiveOrder", "ThreadSharedState", "DtypePromotionLeak",
           "CollectiveUnderRankLocalBranch", "FLOW_RULES"]


def _src(node: ast.AST, limit: int = 58) -> str:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse failure
        text = node.__class__.__name__
    text = " ".join(text.split())
    return text if len(text) <= limit else text[: limit - 3] + "..."


class _CfgCache:
    """FunctionCFGs are built lazily, once per function, per rule run."""

    def __init__(self):
        self._cfgs: Dict[int, FunctionCFG] = {}

    def get(self, fn_node: ast.AST) -> FunctionCFG:
        cfg = self._cfgs.get(id(fn_node))
        if cfg is None:
            cfg = FunctionCFG(fn_node)
            self._cfgs[id(fn_node)] = cfg
        return cfg


def _enclosing_chain(ctx: LintContext, key: Key):
    """FuncInfos from outermost enclosing function to ``key``'s own."""
    chain = []
    info = ctx.graph.funcs.get(key)
    while info is not None:
        chain.append(info)
        info = ctx.graph.funcs.get((info.relpath, info.parent_qual)) \
            if info.parent_qual else None
    chain.reverse()
    return chain


# ---------------------------------------------------------------------
class CollectiveOrder(Rule):
    """TPL007: every host-level collective must be reached in
    rank-invariant order. Three rank-divergence shapes are flagged:

    - a collective whose guard pins (CFG meet over all paths) include a
      rank-derived condition — a ``process_index()`` /
      ``LIGHTGBM_TPU_RANK`` branch, *including* the early-return shape
      where one arm diverts (``if rank: return`` then a collective);
    - a collective inside an ``except`` handler or ``finally`` block —
      only the ranks that hit the exception run it;
    - a collective in a loop whose iterable is rank-derived — a
      rank-dependent number of joins.

    Rank-dependent *arguments* are fine (``sync_bin_mappers`` builds
    rank 0's payload under a rank branch, then every rank joins the
    broadcast) — the CFG meet keeps fall-through branches pin-free.
    """

    id = "TPL007"
    title = "host collective reached in rank-divergent order"

    #: the collectives (basenames — matches resolved package functions,
    #: unresolved externals and method calls alike): the JAX package's
    #: host collectives and their port counterparts (``parallel/
    #: hostsync.py``, ``spmd.py``, ``placement.py``), the calls of
    #: ``torch.distributed``, the ``Comm`` methods and the histogram
    #: reductions of ``parallel/comms.py`` and ``data_parallel.py``
    _COLLECTIVES = PORT_COLLECTIVES

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        reaches = self._reaches_collective(ctx.graph)
        # gather the scoped collective call sites FIRST: a scope with
        # none (the common --changed slice) never pays for the
        # package-wide rank-taint fixed point
        sites = []
        for scope, facts in ctx.graph.facts.items():
            if scope is None or ctx.is_traced(scope):
                continue
            for rec in facts.records:
                if rec.relpath not in ctx.scope:
                    continue
                name, direct = self._collective_name(rec, reaches)
                if name is not None:
                    sites.append((scope, rec, name, direct))
        if not sites:
            return
        tainted_fns = rank_tainted_returns(ctx.graph)
        cfgs = _CfgCache()
        taints: Dict[Key, RankTaint] = {}
        for scope, rec, name, direct in sites:
            info = ctx.graph.funcs.get(scope)
            if info is None:
                continue
            cfg = cfgs.get(info.node)
            unit = cfg.info(rec.node)
            if unit is None:
                continue
            what = name if direct else f"{name} (reaches a host " \
                "collective through the call graph)"
            if unit.in_except or unit.in_finally:
                where = "an `except` handler" if unit.in_except \
                    else "a `finally` block"
                yield self._finding(
                    ctx, rec.relpath, rec.node,
                    f"collective:{name}",
                    f"host collective {what} runs inside {where}: "
                    "only the ranks that hit the exception path "
                    "join it, so the world's collective sequences "
                    "diverge — the survivors hang in mismatched "
                    "collectives until the watchdog deadline. Keep "
                    "collectives out of error-recovery paths; fail "
                    "fast and let the supervisor restart the world "
                    "(resilience/elastic.py).",
                    func=scope[1])
                continue
            taint = self._taint_for(ctx, scope, tainted_fns, taints)
            hit = next(((t, pol) for (t, pol) in unit.pins
                        if taint.is_tainted(t)), None)
            if hit is None:
                continue
            test, pol = hit
            shape = ("a rank-dependent number of times (loop over "
                     f"`{_src(test)}`)"
                     if self._is_loop_iter(cfg, test)
                     else f"only when `{_src(test)}` is {pol}")
            yield self._finding(
                ctx, rec.relpath, rec.node, f"collective:{name}",
                f"host collective {what} is reached {shape} — a "
                "condition derived from the process rank "
                "(process_index() / a *RANK* env var): ranks take "
                "different paths, so part of the world never joins "
                "(or joins out of order) and the rest deadlocks "
                "until the watchdog deadline. Make every rank join "
                "the collective and branch on the rank only for "
                "its *arguments* or for local side effects "
                "(parallel/spmd.sync_bin_mappers is the pattern).",
                func=scope[1])

    @staticmethod
    def _is_loop_iter(cfg: FunctionCFG, node: ast.AST) -> bool:
        unit = cfg.info(node)
        return unit is not None and isinstance(unit.stmt,
                                               (ast.For, ast.AsyncFor))

    def _collective_name(self, rec: CallRecord,
                         reaches: Set[Key]) -> Tuple[Optional[str], bool]:
        if rec.kind == "ext" and rec.dotted:
            base = rec.dotted.rsplit(".", 1)[-1]
            if base in self._COLLECTIVES:
                return base, True
        elif rec.kind == "method" and rec.attr in self._COLLECTIVES:
            return rec.attr, True
        elif rec.kind == "known" and rec.target is not None:
            base = rec.target[1].rsplit(".", 1)[-1]
            if base in self._COLLECTIVES:
                return base, True
            if rec.target in reaches:
                return base, False
        return None, False

    @staticmethod
    def _reaches_collective(graph: CallGraph) -> Set[Key]:
        """Functions that transitively call a host collective —
        rank-gating a *call* to one of these is the same hazard one
        level up."""
        direct: Set[Key] = set()
        for scope, facts in graph.facts.items():
            if scope is None:
                continue
            for rec in facts.records:
                base = None
                if rec.kind == "ext" and rec.dotted:
                    base = rec.dotted.rsplit(".", 1)[-1]
                elif rec.kind == "method":
                    base = rec.attr
                if base in CollectiveOrder._COLLECTIVES:
                    direct.add(scope)
        callers: Dict[Key, Set[Optional[Key]]] = {}
        for scope, facts in graph.facts.items():
            for rec in facts.records:
                if rec.kind == "known" and rec.target is not None:
                    callers.setdefault(rec.target, set()).add(scope)
        out = set(direct)
        frontier = list(direct)
        while frontier:
            k = frontier.pop()
            for caller in callers.get(k, ()):
                if caller is not None and caller not in out:
                    out.add(caller)
                    frontier.append(caller)
        return out

    @staticmethod
    def _taint_for(ctx: LintContext, key: Key, tainted_fns: Set[str],
                   cache: Dict[Key, RankTaint]) -> RankTaint:
        got = cache.get(key)
        if got is not None:
            return got
        names: Set[str] = set()
        taint: Optional[RankTaint] = None
        for info in _enclosing_chain(ctx, key):
            taint = RankTaint(info.node, seed_names=names,
                              tainted_fns=tainted_fns)
            names = set(taint.names)
        assert taint is not None
        cache[key] = taint
        return taint


# ---------------------------------------------------------------------
class ThreadSharedState(Rule):
    """TPL008: state written from thread-started code (a
    ``threading.Thread``/``Timer`` target, or the collective body a
    ``watchdog.guarded`` call runs on its worker thread) and shared
    with other code must be guarded by a *common* lock — proved on the
    lock-acquisition CFG, not syntactically — or carry a
    ``# tpulint: threadsafe <why>`` pragma explaining the
    synchronization that makes it safe (e.g. an Event handshake).

    Shared state = module globals (including imported ones), ``self``
    attributes, and closure variables of an enclosing function;
    mutation = assignment, subscript/attribute store, or a mutating
    method call (``append``/``update``/...). A module global mutated
    from thread-side code is flagged even without a main-path reader:
    every spawn is a *fresh* thread, so two successive collectives
    already race on it. Scope includes ``serve/``: the inference
    daemon's batcher worker, hot-swap watcher and stats loop all
    mutate state that submit()/stats() callers read concurrently —
    and ``pipeline.py``, whose load-generator thread records outcome
    stats the supervisor loop snapshots."""

    id = "TPL008"
    title = "thread-shared state mutated without a common lock"

    _SCOPE_PREFIXES = ("obs/", "resilience/", "parallel/", "serve/",
                       "pipeline")

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        thread_side = thread_side_functions(ctx.graph)
        if not thread_side:
            return
        cfgs = _CfgCache()
        for key in sorted(thread_side):
            relpath, qual = key
            if relpath not in ctx.scope \
                    or not relpath.startswith(self._SCOPE_PREFIXES):
                continue
            info = ctx.graph.funcs.get(key)
            scan = ctx.scans.get(relpath)
            if info is None or scan is None:
                continue
            how, _ = thread_side[key]
            yield from self._check_thread_fn(ctx, scan, info, how,
                                             thread_side, cfgs)

    # -- helpers -------------------------------------------------------
    @staticmethod
    def _own_nodes(fn_node: ast.AST):
        """Nodes of this function, not descending into nested defs."""
        stack = list(getattr(fn_node, "body", []))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    @classmethod
    def _local_names(cls, fn_node: ast.AST) -> Set[str]:
        a = fn_node.args
        out = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
        if a.vararg:
            out.add(a.vararg.arg)
        if a.kwarg:
            out.add(a.kwarg.arg)
        globals_decl: Set[str] = set()
        for node in cls._own_nodes(fn_node):
            if isinstance(node, ast.Global):
                globals_decl.update(node.names)
            elif isinstance(node, ast.Nonlocal):
                continue  # nonlocal stores are shared, not local
            elif isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Store):
                out.add(node.id)
            elif isinstance(node, ast.excepthandler) and node.name:
                out.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    out.add((alias.asname
                             or alias.name.split(".", 1)[0]))
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(node.name)
        return out - globals_decl

    @staticmethod
    def _root_name(node: ast.AST) -> Optional[str]:
        while isinstance(node, (ast.Subscript, ast.Attribute,
                                ast.Starred)):
            node = node.value
        if isinstance(node, ast.Name):
            return node.id
        return None

    @classmethod
    def _sync_primitives(cls, ctx: LintContext, scan: ModuleScan,
                         info) -> Set[str]:
        """Names bound to objects that synchronize internally (Event,
        Queue, deque, itertools.count, ...) in this function, its
        enclosing chain, or at module level."""
        out: Set[str] = set()

        def collect(node):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) \
                        and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name) \
                        and isinstance(sub.value, ast.Call):
                    d = dotted_of(sub.value.func) or ""
                    if d.rsplit(".", 1)[-1] in SYNC_PRIMITIVE_CTORS:
                        out.add(sub.targets[0].id)

        for fi in _enclosing_chain(ctx, info.key):
            collect(fi.node)
        collect(scan.tree)
        return out

    @staticmethod
    def _module_globals(scan: ModuleScan) -> Set[str]:
        out: Set[str] = set(scan.imports)
        for node in scan.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                out.add(node.target.id)
        return out

    def _threadsafe_ok(self, scan: ModuleScan, info,
                       lineno: int) -> bool:
        for ln in (lineno, lineno - 1, info.lineno, info.lineno - 1):
            if scan.threadsafe_lines.get(ln):
                return True
        return False

    # -- the check -----------------------------------------------------
    def _check_thread_fn(self, ctx, scan, info, how, thread_side,
                         cfgs: _CfgCache) -> Iterator[Finding]:
        locals_ = self._local_names(info.node)
        sync_names = self._sync_primitives(ctx, scan, info)
        mod_globals = self._module_globals(scan)
        enclosing = {fi.qual for fi in _enclosing_chain(ctx, info.key)}
        enclosing.discard(info.qual)
        cfg = cfgs.get(info.node)

        writes: List[Tuple[ast.AST, str, str]] = []  # (node, sym, kind)
        for node in self._own_nodes(info.node):
            for target, wnode in self._write_targets(node):
                sym, kind = self._classify(target, locals_, sync_names,
                                           mod_globals, scan, info)
                if sym is not None:
                    writes.append((wnode, sym, kind))

        seen: Set[Tuple[str, int]] = set()
        for wnode, sym, kind in writes:
            lineno = getattr(wnode, "lineno", info.lineno)
            if (sym, lineno) in seen:
                continue
            seen.add((sym, lineno))
            if self._threadsafe_ok(scan, info, lineno):
                continue
            wlocks = cfg.held_locks(wnode)
            accesses = self._main_side_accesses(
                ctx, scan, info, sym, kind, thread_side, cfgs)
            unsafe = [
                (ln, locks) for (ln, locks) in accesses
                if not (wlocks & locks)]
            if accesses and not unsafe:
                continue  # common lock proven on every main-side access
            if not accesses:
                if kind != "global" or wlocks:
                    continue
                detail = ("no lock is held at the write, and every "
                          f"{how} spawn is a FRESH thread — successive "
                          "collectives already race on it")
            else:
                ln = unsafe[0][0]
                detail = ("main-path code accesses it at line "
                          f"{ln} with no lock in common with this "
                          "write" + ("" if wlocks else
                                     " (the write holds no lock at "
                                     "all)"))
            yield self._finding(
                ctx, scan.relpath, wnode, f"shared:{sym}",
                f"`{sym}` is mutated from thread-side code "
                f"({info.qual} runs on a {how} thread) without a "
                f"common lock: {detail}. Guard both sides with one "
                "lock (copy-under-lock, dispatch outside — "
                "docs/STATIC_ANALYSIS.md), hand the data over through "
                "a queue/Event, or mark the write `# tpulint: "
                "threadsafe <why>` when an existing handshake already "
                "orders it.", func=info.qual)

    def _write_targets(self, node):
        """(target expr, finding anchor) pairs for every mutation in
        ``node``."""
        if isinstance(node, ast.Assign):
            for t in node.targets:
                yield t, node
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if getattr(node, "value", True) is not None:
                yield node.target, node
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                yield t, node
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATOR_METHODS:
            yield node.func.value, node

    def _classify(self, target, locals_, sync_names, mod_globals,
                  scan, info):
        """-> (symbol, kind) with kind in global|closure|attr, or
        (None, "") when the write is purely local."""
        # plain local rebinding is local by Python scoping
        if isinstance(target, ast.Name):
            if target.id in mod_globals and target.id not in locals_:
                return target.id, "global"
            return None, ""
        root = self._root_name(target)
        if root is None:
            # self.attr / chained attribute write
            node = target
            while isinstance(node, (ast.Subscript, ast.Attribute)):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id in ("self", "cls"):
                    return f"self.{node.attr}", "attr"
                node = node.value
            return None, ""
        if root in ("self", "cls"):
            sub = target
            while isinstance(sub, ast.Subscript):
                sub = sub.value
            if isinstance(sub, ast.Attribute):
                return f"self.{sub.attr}", "attr"
            return None, ""
        if root in locals_ or root in sync_names:
            return None, ""
        if root in mod_globals:
            return root, "global"
        # not local, not a module global: bound in an enclosing
        # function -> closure variable
        return root, "closure"

    def _main_side_accesses(self, ctx, scan, info, sym, kind,
                            thread_side, cfgs: _CfgCache):
        """(lineno, held-locks) for every access to ``sym`` from
        non-thread-side code that can see it."""
        out: List[Tuple[int, frozenset]] = []

        def scan_fn(fi):
            if fi.key in thread_side or fi.key == info.key:
                return
            if fi.name in ("__init__", "__new__", "__post_init__"):
                # constructors run before any thread can see the
                # object — their unguarded initialization is not a race
                return
            cfg = cfgs.get(fi.node)
            for node in ThreadSharedState._own_nodes(fi.node):
                hit = False
                if kind == "attr":
                    hit = (isinstance(node, ast.Attribute)
                           and isinstance(node.value, ast.Name)
                           and node.value.id in ("self", "cls")
                           and f"self.{node.attr}" == sym)
                else:
                    hit = isinstance(node, ast.Name) and node.id == sym
                if hit:
                    out.append((node.lineno, cfg.held_locks(node)))

        if kind == "attr":
            for fi in scan.funcs.values():
                if fi.class_name == info.class_name:
                    scan_fn(fi)
        elif kind == "closure":
            for fi in _enclosing_chain(ctx, info.key):
                if fi.key != info.key:
                    scan_fn(fi)
        else:  # module global (possibly imported from another module)
            for fi in scan.funcs.values():
                scan_fn(fi)
            origin = scan.imports.get(sym)
            if origin and "." in origin:
                mod = origin.rsplit(".", 1)[0]
                rel = ctx.graph.module_of.get(mod)
                if rel and rel in ctx.scans:
                    for fi in ctx.scans[rel].funcs.values():
                        scan_fn(fi)
        return out


# ---------------------------------------------------------------------
class DtypePromotionLeak(Rule):
    """TPL009: a float64 numpy value made into a tensor on the card, in
    code a ``# tpulint: hot`` driver reaches, without a dtype:
    ``torch.as_tensor`` / ``torch.tensor`` with a ``device=``, or
    ``torch.from_numpy`` / ``as_tensor`` / ``tensor`` followed by
    ``.to(dev)`` / ``.cuda()`` with no dtype. The tensor arrives as
    float64: every kernel it meets then runs at the card's float64
    rate (a fraction of float32's) or converts it once a call, and the
    upload moves twice the bytes. Give the maker ``dtype=`` (or build
    the array float32). The JAX package's TPL009 asks the same of a
    value entering jit; an explicit ``dtype=torch.float64`` is a
    choice, not a leak (the grower's split rounding and the linear
    fits use float64 on purpose)."""

    id = "TPL009"
    title = "float64 numpy value uploaded in hot code without a dtype"

    _MAKERS = {"as_tensor", "tensor", "from_numpy"}

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for scope, facts in ctx.graph.facts.items():
            if scope is None or not ctx.is_hot(scope) \
                    or scope[0] not in ctx.scope:
                continue
            scan = ctx.scans[scope[0]]
            assigns = None
            for rec in facts.records:
                maker, on_device = self._upload(rec, scan)
                if maker is None or not maker.args:
                    continue
                if assigns is None:
                    assigns = self._f64_assigns(ctx, scope, scan)
                if not is_float64_expr(maker.args[0], scan.imports,
                                       assigns):
                    continue
                yield self._finding(
                    ctx, rec.relpath, rec.node,
                    f"f64-upload:{dotted_of(maker.func) or 'tensor'}",
                    f"float64 numpy value uploaded by `{_src(rec.node)}`"
                    f" in {scope[1]}(), which a per-iteration hot driver "
                    "reaches, without a dtype: the tensor lands on "
                    f"{on_device} as float64, so the upload moves twice "
                    "the bytes and every op on it runs at the float64 "
                    "rate or converts it per call. Pass dtype= (or "
                    "build the array float32).", func=scope[1])

    def _is_maker(self, node: ast.AST, scan: ModuleScan) -> bool:
        if not isinstance(node, ast.Call):
            return False
        d = dotted_of(node.func) or ""
        parts = d.split(".")
        if parts[-1] not in self._MAKERS or len(parts) < 2:
            return False
        root = scan.imports.get(parts[0], parts[0]).split(".", 1)[0]
        return root == "torch" and not _has_dtype(node)

    def _upload(self, rec: CallRecord, scan: ModuleScan
                ) -> Tuple[Optional[ast.Call], str]:
        """(the maker call, where it lands) when ``rec`` puts a
        dtype-less tensor made from a host value on a device."""
        node = rec.node
        if self._is_maker(node, scan) \
                and any(kw.arg == "device" for kw in node.keywords):
            return node, "its device="
        if rec.kind == "method" and rec.attr in ("to", "cuda") \
                and not _has_dtype(node) \
                and self._is_maker(node.func.value, scan):
            return node.func.value, f".{rec.attr}()'s device"
        return None, ""

    @staticmethod
    def _f64_assigns(ctx: LintContext, scope: Optional[Key],
                     scan: ModuleScan) -> Dict:
        """name -> [(lineno, was_f64)] history for the enclosing
        function (one level of local propagation)."""
        out: Dict[str, List[Tuple[int, bool]]] = {}
        info = ctx.graph.funcs.get(scope) if scope is not None else None
        node = info.node if info is not None else scan.tree
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                out.setdefault(sub.targets[0].id, []).append(
                    (sub.lineno,
                     is_float64_expr(sub.value, scan.imports)))
        for hist in out.values():
            hist.sort()
        return out


def _has_dtype(call: ast.Call) -> bool:
    """Does a tensor maker or ``.to`` call name a dtype (``dtype=``, or
    a positional ``torch.<float/int type>``)?"""
    if any(kw.arg == "dtype" for kw in call.keywords):
        return True
    for a in call.args:
        d = dotted_of(a) or ""
        if d.startswith("torch.") and d.split(".")[-1] != "device":
            return True
    return False


# ---------------------------------------------------------------------
class CollectiveUnderRankLocalBranch(Rule):
    """TPL010: a collective inside a branch (``if`` / ``while``) whose
    predicate is a rank-local read-back — ``.item()``, ``.tolist()``,
    ``.numpy()`` or ``.cpu()`` of a tensor, directly or through a local
    assigned from one — that no collective has made uniform. Each rank
    reads back its own value; where they differ, part of the world
    joins the collective and the rest never does, and the world hangs
    until the process group's timeout (the device collectives sit below
    the host watchdog TPL007 polices). This is the port's form of the
    JAX package's TPL010 (a device collective in a ``lax.cond``
    branch): there the predicate is a traced value, here a read-back.

    A read-back is uniform when its tensor came out of a collective
    (``flag = comm.all_reduce(flag)``; ``dist.all_reduce(flag)`` in
    place before the branch; ``comm.all_reduce(x).item()``). Otherwise
    the site must carry ``# tpulint: replicated-cond <why>`` (on the
    branch's line or the one above) naming why every rank reads the
    same value; a bare pragma does not suppress."""

    id = "TPL010"
    title = "collective under a branch on a rank-local read-back"

    _READBACKS = {"item", "tolist", "numpy", "cpu"}

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        reaches = CollectiveOrder._reaches_collective(ctx.graph)
        for scan in ctx.scoped_scans():
            for qual, info in scan.funcs.items():
                facts = ctx.graph.facts.get(info.key)
                if facts is None:
                    continue
                yield from self._check_function(ctx, scan, qual, info,
                                                facts, reaches)

    def _check_function(self, ctx, scan, qual, info, facts, reaches):
        if not any(self._collective_of(rec, reaches) for rec in
                   facts.records):
            return
        fn = info.node
        readback_names = self._readback_names(fn)
        uniform = self._uniform_names(fn)
        for node in _own_walk(fn):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            local = self._local_readback(node.test, readback_names,
                                         uniform, node.lineno)
            if local is None:
                continue
            hit = self._body_collective(node, facts, reaches)
            if hit is None:
                continue
            why = None
            for ln in (node.lineno, node.lineno - 1):
                if ln in scan.replicated_cond_lines:
                    why = scan.replicated_cond_lines[ln]
                    break
            if why:
                continue
            name, rec = hit
            bare = "" if why is None else \
                " The pragma on this site has no why — state it."
            yield self._finding(
                ctx, scan.relpath, rec.node,
                f"readback-cond-collective:{name}",
                f"collective {name} runs under `{_src(node.test)}`, a "
                f"branch on a rank-local read-back ({local}): ranks "
                "that read back different values take different "
                "branches, so part of the world never joins and the "
                "rest hang until the process group's timeout. Reduce "
                "the value across ranks before branching on it, or "
                "annotate the branch with `# tpulint: replicated-cond "
                "<why>`." + bare, func=qual)

    def _readback_call(self, node: ast.AST) -> Optional[ast.Call]:
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in self._READBACKS:
            return node
        return None

    def _readback_names(self, fn) -> Dict[str, List[Tuple[int, ast.AST]]]:
        """Locals assigned from an expression holding a read-back:
        name -> [(lineno, the read-back's receiver)]."""
        out: Dict[str, List[Tuple[int, ast.AST]]] = {}
        for sub in _own_walk(fn):
            if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                    and isinstance(sub.targets[0], ast.Name)):
                continue
            for inner in ast.walk(sub.value):
                call = self._readback_call(inner)
                if call is not None:
                    out.setdefault(sub.targets[0].id, []).append(
                        (sub.lineno, call.func.value))
                    break
        return out

    @staticmethod
    def _uniform_names(fn) -> Dict[str, int]:
        """Locals a collective made uniform: name -> the first line it
        was (assigned from, or passed in place to) a collective."""
        out: Dict[str, int] = {}
        for sub in _own_walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            base = (dotted_of(sub.func) or "").rsplit(".", 1)[-1]
            if base not in PORT_COLLECTIVES:
                continue
            for a in sub.args[:1]:
                root = _root_name(a)
                if root is not None:
                    out.setdefault(root, sub.lineno)
        for sub in _own_walk(fn):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name) \
                    and _holds_collective(sub.value):
                name = sub.targets[0].id
                out[name] = min(out.get(name, sub.lineno), sub.lineno)
        return out

    def _local_readback(self, test, readback_names, uniform,
                        lineno: int) -> Optional[str]:
        """The first rank-local read-back the predicate holds, or
        None."""
        for sub in ast.walk(test):
            call = self._readback_call(sub)
            if call is not None:
                recv = call.func.value
                if _holds_collective(recv):
                    continue
                root = _root_name(recv)
                if root is not None and uniform.get(root, 10 ** 9) \
                        < lineno:
                    continue
                return f".{call.func.attr}() of `{_src(recv, 30)}`"
            if isinstance(sub, ast.Name) and sub.id in readback_names:
                last = None
                for ln, recv in readback_names[sub.id]:
                    if ln < lineno:
                        last = recv
                if last is None or _holds_collective(last):
                    continue
                root = _root_name(last)
                if root is not None and uniform.get(root, 10 ** 9) \
                        < lineno:
                    continue
                return f"`{sub.id}`, read back from `{_src(last, 30)}`"
        return None

    @staticmethod
    def _collective_of(rec: CallRecord, reaches) -> Optional[str]:
        """The collective a call record is, or reaches, or None."""
        if rec.kind == "method":
            base = rec.attr
        elif rec.dotted:
            base = rec.dotted.rsplit(".", 1)[-1]
        elif rec.kind == "known" and rec.target is not None:
            base = rec.target[1].rsplit(".", 1)[-1]
        else:
            base = None
        if base in PORT_COLLECTIVES:
            return base
        if rec.kind == "known" and rec.target in reaches:
            return rec.target[1].rsplit(".", 1)[-1]
        return None

    def _body_collective(self, node, facts, reaches
                         ) -> Optional[Tuple[str, CallRecord]]:
        lo = min(s.lineno for s in node.body + node.orelse)
        hi = max(getattr(s, "end_lineno", s.lineno)
                 for s in node.body + node.orelse)
        for rec in facts.records:
            if lo <= rec.node.lineno <= hi:
                name = self._collective_of(rec, reaches)
                if name is not None:
                    return name, rec
        return None


def _own_walk(fn):
    """A function's own nodes, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _holds_collective(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            base = (dotted_of(sub.func) or "").rsplit(".", 1)[-1]
            if base in PORT_COLLECTIVES:
                return True
    return False


FLOW_RULES: List[Rule] = [CollectiveOrder(), ThreadSharedState(),
                          DtypePromotionLeak(),
                          CollectiveUnderRankLocalBranch()]

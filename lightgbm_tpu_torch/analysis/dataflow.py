"""Dataflow lattices for the distributed-safety rules: the port's copy
of ``lightgbm_tpu/analysis/dataflow.py``. Pure stdlib.

The port's rank sources extend the JAX package's: ``dist.get_rank()``
and ``parallel/mesh.py`` ``world_rank()`` (basenames, like
``process_index``) and any ``.rank`` attribute (``Mesh.rank``,
``Comm.rank``, a ``DistGrow``'s). :data:`JAX_RANK_SOURCES` is the JAX
package's set: with it, every analysis here gives the JAX package's
result on the same source.

Three small analyses, consumed by :mod:`~lightgbm_tpu_torch.analysis
.rules_flow` on top of the per-function CFGs:

**Rank taint** (TPL007) — which expressions derive from the *process
rank*? Sources: ``jax.process_index()`` (any spelling that resolves to
a ``process_index`` basename), reads of rank-carrying environment
variables (``LIGHTGBM_TPU_RANK`` and anything else containing
``RANK``), and calls to package functions whose *return value* is
rank-derived (a cross-module fixed point over the call graph, so
``faults.FaultPlan._rank_selected`` taints its callers). Taint
propagates through local assignments — including tuple unpacking, so
``nproc, rank = jax.process_count(), jax.process_index()`` taints only
``rank`` — and through any containing expression. ``process_count()``
is deliberately *not* a source: the world size is rank-invariant.

**Thread-side closure** (TPL008) — which functions run on a thread
other than the caller's? Seeds: ``threading.Thread(target=f)``,
``threading.Timer(t, f)``, and the ``fn`` argument of
``watchdog.guarded(name, fn, ...)`` (the collective watchdog runs it
on a fresh daemon worker). Closed transitively over the call graph, so
a helper called from a guarded collective body is thread-side too.
Method calls on *constructor-typed* receivers are followed as well:
when thread-side code calls ``obj.m(...)`` and ``obj`` was assigned
from ``SomeClass(...)`` in the scope or its enclosing function chain
(the supervisor's ``policy = AutoscalePolicy(...)`` consumed by the
nested scrape loop), ``SomeClass.m`` joins the closure — the plain
reference graph cannot see through a method call on a local.

**float64 producers** (TPL009) — numpy expressions whose value is
float64: explicit ``np.float64`` / ``dtype=np.float64`` /
``.astype("float64")``, and the float64-by-default constructors
(``np.zeros``/``ones``/``empty``/``arange``/``linspace`` with no dtype
argument).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

from .astscan import ModuleScan, dotted_of
from .callgraph import CallGraph, Key

__all__ = ["RankTaint", "rank_tainted_returns", "thread_side_functions",
           "resolve_fn_arg", "is_float64_expr", "MUTATOR_METHODS",
           "SYNC_PRIMITIVE_CTORS", "RankSources", "JAX_RANK_SOURCES",
           "PORT_RANK_SOURCES", "PORT_COLLECTIVES"]

#: collectives whose result is the same on every rank (basenames): the
#: JAX package's host collectives and the port's ``torch.distributed``
#: calls, ``Comm`` methods, histogram reductions and host syncs
PORT_COLLECTIVES = frozenset({
    # the JAX package's host collectives and their port counterparts
    "host_allgather", "host_broadcast_bytes", "guarded",
    "verify_step_consistency", "sync_bin_mappers",
    "aggregate_phase_snapshot", "process_allgather",
    "broadcast_one_to_all", "sync_global_devices", "wait_at_barrier",
    "assert_equal_per_process", "hist_allreduce", "upload_barrier",
    "fetch_global",
    # torch.distributed
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "barrier", "monitored_barrier",
    # parallel/comms.py and parallel/data_parallel.py (``DistGrow.sum``
    # and ``.max`` are collectives too, but share their names with every
    # tensor's reductions)
    "gather_rows", "hist_reduce_scatter", "reduce_hist",
    "reduce_hist_once", "exchange_elected", "combine_split_infos",
    "combine", "elect"})


class RankSources(NamedTuple):
    """What rank taint starts from and where it stops: callables
    (basenames) whose result is this process's rank, attribute names
    that hold it, whether an object built from a rank is opaque (the
    port's ``HostWorld(store, rank, size)`` is not a rank, and its
    ``.rank`` is read through the attribute source, so a constructor
    call — a capitalized callee — does not pass its arguments' taint
    on), and the collectives whose result is uniform across ranks."""
    calls: frozenset
    attrs: frozenset
    opaque_ctors: bool
    uniform: frozenset


JAX_RANK_SOURCES = RankSources(frozenset({"process_index"}), frozenset(),
                               False, frozenset())
PORT_RANK_SOURCES = RankSources(
    frozenset({"process_index", "get_rank", "world_rank"}),
    frozenset({"rank"}), True, PORT_COLLECTIVES)

#: list/dict/set mutators: calling one of these on a shared object is a
#: write for the race analysis
MUTATOR_METHODS = {"append", "extend", "insert", "remove", "pop",
                   "clear", "update", "setdefault", "add", "discard",
                   "popitem", "appendleft", "popleft", "sort",
                   "reverse"}

#: constructors of objects that synchronize internally — accesses to
#: them are exempt from the race analysis
SYNC_PRIMITIVE_CTORS = {"Event", "Condition", "Semaphore",
                        "BoundedSemaphore", "Barrier", "Queue",
                        "SimpleQueue", "LifoQueue", "PriorityQueue",
                        "Lock", "RLock", "local", "deque", "count"}


def _env_name_of(node: ast.AST) -> Optional[str]:
    """The environment-variable name read by this expression, if any:
    ``os.environ["X"]`` / ``os.environ.get("X", ...)`` /
    ``os.getenv("X")``."""
    if isinstance(node, ast.Subscript):
        base = dotted_of(node.value)
        if base and base.endswith("environ"):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                return sl.value
    if isinstance(node, ast.Call) and node.args:
        f = dotted_of(node.func) or ""
        base = f.rsplit(".", 1)[-1]
        env_read = base == "getenv" or (
            base == "get" and isinstance(node.func, ast.Attribute)
            and (dotted_of(node.func.value) or "").endswith("environ"))
        if env_read:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
    return None


def _is_rank_env(name: Optional[str]) -> bool:
    return bool(name) and "RANK" in name.upper()


class RankTaint:
    """Per-function rank-taint facts. ``seed_names`` lets callers feed
    tainted names from enclosing scopes (closures) in; ``tainted_fns``
    is the cross-module returns-rank set from
    :func:`rank_tainted_returns`."""

    def __init__(self, fn_node: ast.AST,
                 seed_names: Iterable[str] = (),
                 tainted_fns: Optional[Set[str]] = None,
                 sources: RankSources = PORT_RANK_SOURCES):
        self.fn_node = fn_node
        self._tainted_fns = tainted_fns or set()
        self._sources = sources
        self.names: Set[str] = set(seed_names)
        self._solve()

    def _own_statements(self):
        """Statements of this function, not descending into nested
        function/class definitions (their bindings are their own)."""
        stack = list(getattr(self.fn_node, "body", []))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    stack.append(child)
                elif isinstance(child, (ast.excepthandler,)):
                    stack.append(child)

    def _solve(self) -> None:
        assigns: List[ast.stmt] = [
            s for s in self._own_statements()
            if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign))]
        for _ in range(len(assigns) + 1):
            changed = False
            for s in assigns:
                if isinstance(s, ast.Assign):
                    targets, value = s.targets, s.value
                elif isinstance(s, ast.AnnAssign):
                    if s.value is None:
                        continue
                    targets, value = [s.target], s.value
                else:  # AugAssign: x += rank keeps/adds taint
                    targets, value = [s.target], s.value
                changed |= self._bind(targets, value)
            if not changed:
                break

    def _bind(self, targets, value) -> bool:
        changed = False
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                if isinstance(value, (ast.Tuple, ast.List)) \
                        and len(t.elts) == len(value.elts):
                    # element-wise: `nproc, rank = count(), index()`
                    # taints only `rank`
                    for te, ve in zip(t.elts, value.elts):
                        changed |= self._bind([te], ve)
                elif self.is_tainted(value):
                    for te in t.elts:
                        changed |= self._bind([te], value)
                continue
            name = self._target_name(t)
            if name is None:
                continue
            if self.is_tainted(value) and name not in self.names:
                self.names.add(name)
                changed = True
        return changed

    @staticmethod
    def _target_name(t: ast.AST) -> Optional[str]:
        if isinstance(t, ast.Name):
            return t.id
        if isinstance(t, ast.Attribute) \
                and isinstance(t.value, ast.Name) \
                and t.value.id in ("self", "cls"):
            return f"{t.value.id}.{t.attr}"
        if isinstance(t, ast.Starred):
            return RankTaint._target_name(t.value)
        return None

    def is_tainted(self, expr: Optional[ast.AST]) -> bool:
        """Does any sub-expression derive from the process rank?"""
        if expr is None:
            return False
        for sub in self._walk(expr):
            if isinstance(sub, ast.Name) and sub.id in self.names:
                return True
            if isinstance(sub, ast.Attribute):
                d = dotted_of(sub)
                if d in self.names:
                    return True
                if sub.attr in self._sources.attrs \
                        and isinstance(sub.ctx, ast.Load):
                    return True
            if isinstance(sub, ast.Call):
                f = dotted_of(sub.func) or ""
                base = f.rsplit(".", 1)[-1]
                if base in self._sources.calls:
                    return True
                if base in self._tainted_fns \
                        or f in self._tainted_fns:
                    return True
            if _is_rank_env(_env_name_of(sub)):
                return True
        return False


    def _walk(self, expr: ast.AST):
        """``ast.walk``, not descending into the arguments of a
        collective (its result is uniform) or, when objects built from a
        rank are opaque, of a constructor."""
        src = self._sources
        if not (src.opaque_ctors or src.uniform):
            yield from ast.walk(expr)
            return
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Call):
                base = (dotted_of(node.func) or "").rsplit(".", 1)[-1]
                if base in src.uniform:
                    continue
                if src.opaque_ctors and base[:1].isupper():
                    yield node
                    stack.append(node.func)
                    continue
            yield node
            stack.extend(ast.iter_child_nodes(node))


def _fn_summary(fn_node, sources: RankSources = PORT_RANK_SOURCES):
    """One own-statement walk (nested defs excluded — their returns
    must not taint the outer name): (return value exprs, called
    basenames, has a direct rank source)."""
    rank_calls, rank_attrs = sources.calls, sources.attrs
    returns: List[ast.expr] = []
    calls: Set[str] = set()
    direct = False
    stack = list(getattr(fn_node, "body", []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            returns.append(node.value)
        if isinstance(node, ast.Call):
            f = dotted_of(node.func) or ""
            base = f.rsplit(".", 1)[-1]
            calls.add(base)
            if base in rank_calls:
                direct = True
        if isinstance(node, ast.Attribute) and node.attr in rank_attrs:
            direct = True
        if not direct and _is_rank_env(_env_name_of(node)):
            direct = True
        stack.extend(ast.iter_child_nodes(node))
    return returns, calls, direct


def rank_tainted_returns(graph: CallGraph,
                         sources: RankSources = PORT_RANK_SOURCES
                         ) -> Set[str]:
    """Basenames of package functions whose return value derives from
    the rank — fixed point: a function returning a tainted expression
    taints every caller that uses its result in a condition. Cheap
    summaries gate the expensive per-function taint solve to actual
    candidates (functions touching a rank source, or calling an
    already-tainted name)."""
    summaries = {key: _fn_summary(info.node, sources)
                 for key, info in graph.funcs.items()}
    tainted: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for key, info in graph.funcs.items():
            name = info.name
            if name in tainted:
                continue
            returns, calls, direct = summaries[key]
            if not returns or not (direct or calls & tainted):
                continue
            taint = RankTaint(info.node, tainted_fns=tainted,
                              sources=sources)
            if any(taint.is_tainted(r) for r in returns):
                tainted.add(name)
                changed = True
    return tainted


# ---------------------------------------------------------------------
# thread-side closure
# ---------------------------------------------------------------------

_THREAD_CTORS = {"Thread", "Timer"}

#: request-handler base classes whose methods run on serving-stack
#: threads (socketserver.ThreadingMixIn servers spawn one per
#: connection; http.server.ThreadingHTTPServer likewise)
_HANDLER_BASES = {"BaseRequestHandler", "StreamRequestHandler",
                  "DatagramRequestHandler", "BaseHTTPRequestHandler",
                  "SimpleHTTPRequestHandler", "CGIHTTPRequestHandler"}
#: package-specific: watchdog.guarded(name, fn, ...) runs fn on a fresh
#: daemon worker thread (resilience/watchdog.py)
_GUARDED_BASENAMES = {"guarded"}


def resolve_fn_arg(graph: CallGraph, scan: ModuleScan,
                   scope: Optional[Key],
                   node: ast.AST) -> Optional[Key]:
    """Resolve a function-valued argument (``target=_run`` /
    ``guarded(name, _run)``) to a known function key: nested defs of
    the calling scope (walking the enclosing chain), module-level
    functions, and ``self.method``."""
    if isinstance(node, ast.Name):
        qual = scope[1] if scope else None
        while qual:
            info = scan.funcs.get(f"{qual}.{node.id}")
            if info is not None:
                return info.key
            info = scan.funcs.get(qual)
            qual = info.parent_qual if info is not None else None
        info = scan.funcs.get(node.id)
        if info is not None:
            return info.key
        alias = scan.aliases.get(node.id)
        if alias is not None and alias[0] == "func":
            info = scan.funcs.get(alias[1])
            if info is not None:
                return info.key
        return None
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id in ("self", "cls") and scope:
        info = graph.funcs.get(scope)
        cls = info.class_name if info is not None else None
        if cls:
            target = scan.funcs.get(f"{cls}.{node.attr}")
            if target is not None:
                return target.key
    return None


def _ctor_class_of(scan: ModuleScan, qual: Optional[str],
                   var: str) -> Optional[str]:
    """The class name ``var`` was constructed from, when a
    ``var = SomeClass(...)`` assignment is visible in the function
    ``qual`` or its enclosing chain (closure variables: the
    supervisor assigns ``policy = AutoscalePolicy(...)`` and the
    nested scrape loop calls ``policy.observe(...)``). Only
    ``Name(...)`` constructor calls count, and only names that look
    like classes (leading capital or underscore-prefixed CapWords) —
    a ``rows = load(...)`` assignment must not type ``rows``."""
    while qual:
        info = scan.funcs.get(qual)
        if info is None:
            return None
        for node in ast.walk(info.node):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) \
                    and node.value is not None:
                targets = [node.target]
            else:
                continue
            val = node.value
            if not (isinstance(val, ast.Call)
                    and isinstance(val.func, ast.Name)):
                continue
            name = val.func.id
            if not name.lstrip("_")[:1].isupper():
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id == var:
                    return name
        qual = info.parent_qual
    return None


def _method_call_targets(graph: CallGraph, key: Key,
                         methods_by_qual: Dict[str, Set[Key]]
                         ) -> Set[Key]:
    """Class methods a scope invokes through ``obj.m(...)`` where
    ``obj``'s class is recoverable via :func:`_ctor_class_of`.
    Matching is by ``Class.method`` qualname across every scanned
    module (the class is usually imported from a sibling module, so
    the receiver's scan does not hold its def)."""
    out: Set[Key] = set()
    facts = graph.facts.get(key)
    scan = graph.scans.get(key[0])
    if facts is None or scan is None:
        return out
    for rec in facts.records:
        if rec.kind != "method" or not rec.attr or rec.node is None:
            continue
        fn = rec.node.func
        if not (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)):
            continue
        cls = _ctor_class_of(scan, key[1], fn.value.id)
        if cls is None:
            continue
        out |= methods_by_qual.get(f"{cls}.{rec.attr}", set())
    return out


def thread_side_functions(graph: CallGraph) -> Dict[Key, Tuple[str, int]]:
    """Every function that runs on a spawned thread, mapped to
    ``(how, seed lineno)`` where ``how`` names the spawn site
    (``threading.Thread`` / ``threading.Timer`` /
    ``watchdog.guarded``). Methods of socketserver / http.server
    request-handler subclasses are seeded too: the serving stack
    (ThreadingTCPServer, ThreadingHTTPServer — the serve daemon's
    protocol handler, the /metrics scrape endpoint in obs/export.py)
    invokes ``do_*``/``handle`` on per-connection daemon threads the
    call graph cannot otherwise see. Seeds are closed transitively
    over the call graph: helpers called from thread-side code are
    thread-side."""
    seeds: Dict[Key, Tuple[str, int]] = {}
    for relpath, scan in graph.scans.items():
        handler_classes = {
            cls for cls, bases in scan.class_bases.items()
            if any(base.rsplit(".", 1)[-1] in _HANDLER_BASES
                   for base in bases)}
        if not handler_classes:
            continue
        for info in scan.funcs.values():
            if info.class_name in handler_classes:
                seeds.setdefault(
                    info.key, ("request-handler thread", info.lineno))
    for scope, facts in graph.facts.items():
        for rec in facts.records:
            if rec.node is None:
                continue
            basename = None
            if rec.dotted:
                basename = rec.dotted.rsplit(".", 1)[-1]
            elif rec.kind == "known" and rec.target is not None:
                basename = rec.target[1].rsplit(".", 1)[-1]
            elif rec.kind == "method":
                basename = rec.attr
            if basename is None:
                continue
            scan = graph.scans.get(rec.relpath)
            if scan is None:
                continue
            fn_node = None
            how = None
            if basename in _THREAD_CTORS:
                for kw in rec.node.keywords:
                    if kw.arg == "target":
                        fn_node = kw.value
                if fn_node is None and basename == "Timer" \
                        and len(rec.node.args) >= 2:
                    fn_node = rec.node.args[1]
                how = f"threading.{basename}"
            elif basename in _GUARDED_BASENAMES \
                    and len(rec.node.args) >= 2:
                fn_node = rec.node.args[1]
                how = "watchdog.guarded"
            if fn_node is None:
                continue
            key = resolve_fn_arg(graph, scan, rec.scope, fn_node)
            if key is not None:
                seeds.setdefault(key, (how, rec.node.lineno))
    # transitive closure over the reference graph, plus
    # constructor-typed method calls (refs cannot see through
    # ``policy.observe(...)`` on a closure variable)
    out_edges: Dict[Optional[Key], Set[Key]] = {}
    for r in graph.refs:
        out_edges.setdefault(r.scope, set()).add(r.target)
    methods_by_qual: Dict[str, Set[Key]] = {}
    for scan in graph.scans.values():
        for info in scan.funcs.values():
            if info.class_name:
                methods_by_qual.setdefault(
                    info.key[1], set()).add(info.key)
    result = dict(seeds)
    frontier = list(seeds)
    while frontier:
        k = frontier.pop()
        how, ln = result[k]
        callees = set(out_edges.get(k, ()))
        callees |= _method_call_targets(graph, k, methods_by_qual)
        for callee in callees:
            if callee not in result:
                result[callee] = (how, ln)
                frontier.append(callee)
    return result


# ---------------------------------------------------------------------
# float64 producers
# ---------------------------------------------------------------------

_F64_DEFAULT_CTORS = {"zeros", "ones", "empty", "arange", "linspace",
                      "full"}
_NUMPY_ROOTS = {"numpy", "np"}


def _numpy_rooted(dotted: Optional[str],
                  imports: Dict[str, str]) -> bool:
    if not dotted:
        return False
    root = dotted.split(".", 1)[0]
    resolved = imports.get(root, root)
    return resolved.split(".", 1)[0] in _NUMPY_ROOTS


def _is_f64_dtype(node: ast.AST, imports: Dict[str, str]) -> bool:
    if isinstance(node, ast.Constant):
        return node.value in ("float64", "f8", "double")
    if isinstance(node, ast.Name):
        return node.id == "float"  # np dtype `float` == float64
    d = dotted_of(node)
    if d is None:
        return False
    base = d.rsplit(".", 1)[-1]
    return base in ("float64", "double") and (
        _numpy_rooted(d, imports) or "." not in d)


def is_float64_expr(expr: ast.AST, imports: Dict[str, str],
                    assigns: Optional[Dict[str, List[Tuple[int, bool]]]]
                    = None) -> bool:
    """Is this expression a float64-producing numpy value?

    ``assigns`` (optional) maps local names to an assignment history of
    ``(lineno, was_f64)`` pairs so one level of local propagation works
    (``thr = np.zeros(n); jitted(thr)``).
    """
    if isinstance(expr, ast.Name) and assigns is not None:
        last: Optional[bool] = None
        for lineno, was in assigns.get(expr.id, ()):
            if lineno >= getattr(expr, "lineno", 10 ** 9):
                break
            last = was
        return bool(last)
    if isinstance(expr, ast.BinOp):
        return is_float64_expr(expr.left, imports, assigns) \
            or is_float64_expr(expr.right, imports, assigns)
    if not isinstance(expr, ast.Call):
        return False
    # X.astype(np.float64) / X.astype("float64")
    if isinstance(expr.func, ast.Attribute) \
            and expr.func.attr == "astype" and expr.args:
        return _is_f64_dtype(expr.args[0], imports)
    f = dotted_of(expr.func)
    if f is None:
        return False
    base = f.rsplit(".", 1)[-1]
    if base == "float64" and _numpy_rooted(f, imports):
        return True
    if not _numpy_rooted(f, imports):
        return False
    dtype_args = [kw.value for kw in expr.keywords
                  if kw.arg == "dtype"]
    if base in ("asarray", "array", "full") and len(expr.args) >= 2 \
            and not dtype_args:
        # positional dtype (np.asarray(x, np.float64)) / fill value
        if base == "full":
            pass  # full(shape, fill): dtype is the 3rd positional
        else:
            dtype_args = [expr.args[1]]
    if base in ("zeros", "ones", "empty") and len(expr.args) >= 2 \
            and not dtype_args:
        dtype_args = [expr.args[1]]
    if dtype_args:
        return _is_f64_dtype(dtype_args[0], imports)
    if base in _F64_DEFAULT_CTORS:
        if base == "full":
            # dtype follows the fill value: float fill -> float64
            if len(expr.args) >= 3:
                return _is_f64_dtype(expr.args[2], imports)
            return (len(expr.args) >= 2
                    and isinstance(expr.args[1], ast.Constant)
                    and isinstance(expr.args[1].value, float))
        if base == "arange":
            # int-stepped arange is int64; flag only float arguments
            return any(isinstance(a, ast.Constant)
                       and isinstance(a.value, float)
                       for a in expr.args)
        return True
    return False

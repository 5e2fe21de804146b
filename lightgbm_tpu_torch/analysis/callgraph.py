"""Cross-module call graph, jit-reachability and hot-reachability: the
port's copy of ``lightgbm_tpu/analysis/callgraph.py`` (pure stdlib).

The JAX package's rules ask which functions are only ever *entered*
through a tracing wrapper (``jax.jit`` / ``pjit`` / ``shard_map``): its
jit-reachability is computed here exactly as there, so the graph of a
shared source (the JAX package's lint fixtures) is the JAX package's
call for call. The port has no tracing wrapper, so over its own tree the
set is empty; its rules ask instead which functions run **inside the
training loop's iteration**:

- every reference to a known function is recorded with its referencing
  scope and kind: ``call`` (direct call), ``ref`` (passed as a value),
  ``jit`` (passed into a tracing wrapper), or ``neutral``
  (``register_jit`` pass-throughs that never enter the function);
- a function marked ``# tpulint: hot`` (``GBDTBooster.train_one_iter``,
  ``Grower.grow``, ``Grower._split``, the serving walk) is a per-
  iteration driver, and so is every function defined inside one;
- :attr:`CallGraph.hot_reachable` is the forward closure of the drivers
  over ``call`` and ``ref`` edges: a host sync (TPL002) or a float64
  upload (TPL009) anywhere in it runs every iteration, or every split.

A call on an object the scan cannot type (``self.grower.grow(...)``)
has no edge, which is why each driver carries its own mark.

:meth:`CallGraph.dispatches_device` answers the JAX package's
``dispatches_jax`` for the port: does a function (transitively) put work
on the device — a ``torch.*`` call, a kernel wrapper, a collective?
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .astscan import (FuncInfo, JitWrap, ModuleScan, dotted_of,
                      jit_wrap_kind)

__all__ = ["CallGraph", "CallRecord", "build_callgraph", "scan_package"]

Key = Tuple[str, str]            # (relpath, qualname)

#: tracing entries beyond jit/pjit/shard_map: abstract evaluation
#: traces without dispatching, so a function reference inside it is a
#: traced entry, not an eager one.
_TRACED_ARG_BASENAMES = {"jit", "pjit", "shard_map", "eval_shape",
                         "make_jaxpr"}
_NEUTRAL_BASENAMES = {"register_jit"}

#: dotted roots whose calls dispatch device work: the JAX package's
#: ``jax`` and the port's ``torch``
_DISPATCH_ROOTS = ("jax", "torch")

#: method names that put work on a device or wait for it whatever the
#: receiver (TPL006): copies, read-backs and the collectives of
#: ``torch.distributed`` and ``parallel/comms.py`` ``Comm``
_DISPATCH_METHODS = {"to", "cuda", "cpu", "item", "tolist", "numpy",
                     "synchronize", "all_reduce", "all_gather",
                     "reduce_scatter", "all_to_all", "broadcast",
                     "barrier", "gather_rows"}


@dataclass
class CallRecord:
    """One interesting call site inside a scope (consumed by rules)."""
    kind: str                 # ext | known | wrapper | method
    node: ast.Call
    scope: Optional[Key]      # None = module level
    relpath: str
    dotted: Optional[str] = None      # resolved dotted (ext calls)
    attr: Optional[str] = None        # method name (method calls)
    target: Optional[Key] = None      # known-function target
    wrap: Optional[JitWrap] = None    # wrapper-call metadata
    in_loop: bool = False             # lexically inside for/while


@dataclass
class _Ref:
    target: Key
    scope: Optional[Key]
    kind: str                 # call | ref | jit
    lineno: int


@dataclass
class FuncFacts:
    """Per-scope facts the rules consume."""
    records: List[CallRecord] = field(default_factory=list)
    param_names: Set[str] = field(default_factory=set)  # incl. enclosing


class _Env:
    """Lexical name environment (module -> enclosing defs -> local)."""

    def __init__(self, parent: Optional["_Env"], names: Dict[str, tuple]):
        self.parent = parent
        self.names = names

    def lookup(self, name: str) -> Optional[tuple]:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.names:
                return env.names[name]
            env = env.parent
        return None


class CallGraph:
    def __init__(self, scans: List[ModuleScan]):
        self.scans = {s.relpath: s for s in scans}
        self.funcs: Dict[Key, FuncInfo] = {}
        for s in scans:
            for info in s.funcs.values():
                self.funcs[info.key] = info
        self.module_of: Dict[str, str] = {s.module: s.relpath
                                          for s in scans}
        self.refs: List[_Ref] = []
        self.facts: Dict[Optional[Key], FuncFacts] = {}
        self._global_symbols = self._build_global_symbols()
        for s in scans:
            _ModuleAnalyzer(self, s).run()
        self.jit_reachable: Set[Key] = self._fixed_point()
        self._dispatches: Dict[Key, bool] = self._dispatch_closure()
        self.hot_reachable: Set[Key] = self._hot_closure()

    # -- symbol table --------------------------------------------------
    def _build_global_symbols(self) -> Dict[str, tuple]:
        out: Dict[str, tuple] = {}
        for s in self.scans.values():
            for qual, info in s.funcs.items():
                if "." not in qual:
                    out[f"{s.module}.{qual}"] = ("func", info.key)
            for name, binding in s.aliases.items():
                if binding[0] == "func":
                    tgt = s.funcs.get(binding[1])
                    if tgt is not None:
                        out[f"{s.module}.{name}"] = ("func", tgt.key)
                elif binding[0] == "wrapper":
                    tgt = s.funcs.get(binding[1])
                    out[f"{s.module}.{name}"] = (
                        "wrapper", tgt.key if tgt else None, binding[2])
        return out

    def lookup_dotted(self, dotted: str, _seen=None) -> tuple:
        hit = self._global_symbols.get(dotted)
        if hit is not None:
            return hit
        if dotted in self.module_of:
            return ("module", dotted)
        # a re-export: `pkg.sub.kernel` where sub/__init__.py (or any
        # module) merely imported `kernel` — follow its import table
        mod, _, attr = dotted.rpartition(".")
        if attr and mod in self.module_of:
            scan = self.scans[self.module_of[mod]]
            target = scan.imports.get(attr)
            if target is not None and target != dotted:
                _seen = _seen or set()
                if dotted not in _seen:
                    _seen.add(dotted)
                    return self.lookup_dotted(target, _seen)
        return ("ext", dotted)

    # -- reachability --------------------------------------------------
    def _fixed_point(self) -> Set[Key]:
        refs_by_target: Dict[Key, List[_Ref]] = {}
        for r in self.refs:
            refs_by_target.setdefault(r.target, []).append(r)
        decorated = {k for k, f in self.funcs.items()
                     if f.decorator_wrap is not None}
        traced: Set[Key] = set(decorated)
        for k in self.funcs:
            if k in traced:
                continue
            if refs_by_target.get(k) or self.funcs[k].wrappers:
                traced.add(k)
        changed = True
        while changed:
            changed = False
            for k in list(traced):
                if k in decorated:
                    continue
                for r in refs_by_target.get(k, ()):
                    if r.kind == "jit":
                        continue
                    if r.scope is None or r.scope not in traced:
                        traced.discard(k)
                        changed = True
                        break
        # the greatest fixed point keeps orphan cycles (a recursive
        # helper nothing else references certifies itself); require a
        # real traced ENTRY: forward reachability from an actual jit
        # seed (decorator or jit(f)/shard_map(f) wrapping)
        seeds = decorated | {k for k, f in self.funcs.items()
                             if f.wrappers} \
            | {r.target for r in self.refs if r.kind == "jit"}
        out_edges: Dict[Optional[Key], Set[Key]] = {}
        for r in self.refs:
            out_edges.setdefault(r.scope, set()).add(r.target)
        entered: Set[Key] = set()
        frontier = [k for k in seeds if k in self.funcs]
        while frontier:
            k = frontier.pop()
            if k in entered:
                continue
            entered.add(k)
            frontier.extend(out_edges.get(k, ()))
        return traced & entered

    def _hot_closure(self) -> Set[Key]:
        """Every function a ``# tpulint: hot`` driver (or a function
        nested in one) reaches over ``call`` and ``ref`` edges."""
        seeds = set()
        for k, f in self.funcs.items():
            info: Optional[FuncInfo] = f
            while info is not None:
                if info.is_hot:
                    seeds.add(k)
                    break
                info = self.funcs.get((info.relpath, info.parent_qual)) \
                    if info.parent_qual else None
        out_edges: Dict[Optional[Key], Set[Key]] = {}
        for r in self.refs:
            if r.kind in ("call", "ref"):
                out_edges.setdefault(r.scope, set()).add(r.target)
        out: Set[Key] = set()
        frontier = list(seeds)
        while frontier:
            k = frontier.pop()
            if k in out:
                continue
            out.add(k)
            frontier.extend(out_edges.get(k, ()))
        return out

    def _dispatch_closure(self) -> Dict[Key, bool]:
        """Does calling this function (transitively) dispatch device
        work?"""
        out: Dict[Key, bool] = {}
        calls_out: Dict[Key, Set[Key]] = {k: set() for k in self.funcs}
        for scope, facts in self.facts.items():
            if scope is None:
                continue
            direct = False
            for rec in facts.records:
                if rec.kind == "wrapper":
                    direct = True
                elif rec.kind == "ext" and rec.dotted and (
                        rec.dotted.split(".", 1)[0] in _DISPATCH_ROOTS):
                    direct = True
                elif rec.kind == "method" \
                        and rec.attr in _DISPATCH_METHODS:
                    direct = True
                elif rec.kind == "known" and rec.target is not None:
                    calls_out.setdefault(scope, set()).add(rec.target)
            out[scope] = direct
        for k in self.funcs:
            out.setdefault(k, False)
            calls_out.setdefault(k, set())
        changed = True
        while changed:
            changed = False
            for k, callees in calls_out.items():
                if out.get(k):
                    continue
                if any(out.get(c, False) for c in callees):
                    out[k] = True
                    changed = True
        return out

    def dispatches_device(self, key: Key) -> bool:
        return self._dispatches.get(key, False)

    def record_dispatches(self, rec: CallRecord) -> bool:
        """Does this one call site dispatch device work?"""
        if rec.kind == "wrapper":
            return True
        if rec.kind == "ext" and rec.dotted:
            return rec.dotted.split(".", 1)[0] in _DISPATCH_ROOTS
        if rec.kind == "method":
            return rec.attr in _DISPATCH_METHODS
        if rec.kind == "known" and rec.target is not None:
            return self.dispatches_device(rec.target)
        return False

    # -- convenience ---------------------------------------------------
    def hot_functions(self) -> Set[Key]:
        """The ``# tpulint: hot`` drivers themselves."""
        return {k for k, f in self.funcs.items() if f.is_hot}

    def reachable_in(self, relpath: str) -> Set[str]:
        return {q for (p, q) in self.jit_reachable if p == relpath}


class _ModuleAnalyzer:
    """Phase-2 walk of one module: resolve references + call records."""

    def __init__(self, graph: CallGraph, scan: ModuleScan):
        self.g = graph
        self.s = scan

    def run(self) -> None:
        names: Dict[str, tuple] = {}
        for name, dotted in self.s.imports.items():
            names[name] = self.g.lookup_dotted(dotted)
        classes: Dict[str, Set[str]] = {}
        for qual, info in self.s.funcs.items():
            parts = qual.split(".")
            if len(parts) == 2 and info.class_name == parts[0]:
                classes.setdefault(parts[0], set()).add(parts[1])
        self.classes = classes
        for qual, info in self.s.funcs.items():
            if "." not in qual:
                names[qual] = ("func", info.key)
        for name, binding in self.s.aliases.items():
            if binding[0] == "func":
                tgt = self.s.funcs.get(binding[1])
                if tgt is not None:
                    names[name] = ("func", tgt.key)
            elif binding[0] == "wrapper":
                tgt = self.s.funcs.get(binding[1])
                names[name] = ("wrapper",
                               tgt.key if tgt else None, binding[2])
        for cname in classes:
            names[cname] = ("class", cname)
        env = _Env(None, names)
        self.g.facts.setdefault(None, FuncFacts())
        self._walk_block(self.s.tree, None, env, None, set(), False)

    # -- scope construction --------------------------------------------
    def _enter_function(self, fn_node, env: _Env,
                        outer_params: Set[str]) -> Tuple[_Env, Set[str]]:
        a = fn_node.args
        params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            params.append(a.vararg.arg)
        if a.kwarg:
            params.append(a.kwarg.arg)
        names: Dict[str, tuple] = {p: ("param",) for p in params}
        # sibling/nested defs + local aliases + local imports
        for child in ast.walk(fn_node):
            for name, dotted in self.s.import_bindings(child):
                names.setdefault(name, self.g.lookup_dotted(dotted))
        # defs anywhere in this function's own statements (loop/if
        # bodies included), but not inside nested functions — those
        # bind in the nested scope
        stack = list(fn_node.body)
        while stack:
            child = stack.pop()
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                qual = self._qual_of(child)
                if qual:
                    names[child.name] = ("func", (self.s.relpath, qual))
                continue
            if isinstance(child, ast.ClassDef):
                continue
            stack.extend(ast.iter_child_nodes(child))
        for child in fn_node.body:
            if isinstance(child, ast.Assign) and len(child.targets) == 1 \
                    and isinstance(child.targets[0], ast.Name):
                got = self._local_wrap_or_func(child.value, names)
                if got is not None:
                    names[child.targets[0].id] = got
        all_params = outer_params | {p for p in params}
        return _Env(env, names), all_params

    def _local_wrap_or_func(self, value, names):
        if isinstance(value, ast.Name) and names.get(value.id, (None,))[0] \
                == "func":
            return names[value.id]
        if isinstance(value, ast.Call):
            base = dotted_of(value.func) or ""
            kind = jit_wrap_kind(base)
            if kind and value.args and isinstance(value.args[0], ast.Name):
                tgt = names.get(value.args[0].id)
                from .astscan import _wrap_from_call_kwargs
                w = _wrap_from_call_kwargs(kind, value.lineno,
                                           value.keywords)
                return ("wrapper",
                        tgt[1] if tgt and tgt[0] == "func" else None, w)
        return None

    def _qual_of(self, fn_node) -> Optional[str]:
        for qual, info in self.s.funcs.items():
            if info.node is fn_node:
                return qual
        return None

    # -- traversal -----------------------------------------------------
    def _walk_block(self, node, scope: Optional[Key], env: _Env,
                    cls: Optional[str], params: Set[str],
                    in_loop: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for deco in child.decorator_list:
                    self._visit_expr(deco, scope, env, cls, params,
                                     in_loop, "plain")
                qual = self._qual_of(child)
                if qual is None:
                    continue
                info = self.s.funcs[qual]
                child_env, child_params = self._enter_function(
                    child, env, params)
                key = info.key
                self.g.facts.setdefault(key, FuncFacts()).param_names \
                    |= child_params
                self._walk_block(child, key, child_env,
                                 info.class_name, child_params, False)
            elif isinstance(child, ast.ClassDef):
                self._walk_block(child, scope, env, child.name, params,
                                 in_loop)
            elif isinstance(child, (ast.For, ast.AsyncFor, ast.While)):
                # loop bodies re-enter the SAME dispatch (a function
                # defined inside a loop body must still get its own
                # scope), just with in_loop set
                self._walk_block(child, scope, env, cls, params, True)
            elif isinstance(child, ast.expr):
                self._visit_expr(child, scope, env, cls, params,
                                 in_loop, "plain")
            else:
                self._walk_block(child, scope, env, cls, params, in_loop)

    # -- expression resolution -----------------------------------------
    def _resolve(self, node, env: _Env, cls: Optional[str]):
        """-> ("func", key) | ("wrapper", key|None, wrap) | ("ext", dotted)
        | ("param",) | None."""
        if isinstance(node, ast.Name):
            return env.lookup(node.id)
        if isinstance(node, ast.Attribute):
            dotted = dotted_of(node)
            if dotted is None:
                return None
            root, _, rest = dotted.partition(".")
            if root in ("self", "cls") and cls is not None and rest \
                    and "." not in rest:
                if rest in self.classes.get(cls, ()):
                    return ("func", (self.s.relpath, f"{cls}.{rest}"))
                wrap = self.s.attr_wrappers.get((cls, rest))
                if wrap is not None:
                    return ("wrapper", None, wrap[1])
                return None
            base = env.lookup(root)
            if base is None:
                return None
            if base[0] in ("module", "ext"):
                return self.g.lookup_dotted(f"{base[1]}.{rest}")
            return None
        return None

    def _visit_expr(self, node, scope, env, cls, params, in_loop,
                    ctx: str) -> None:
        """ctx: how a *function-valued* name found here is entered —
        "plain" (eager ref), "traced" (inside a jit-wrapper argument),
        "neutral" (register_jit pass-through)."""
        if isinstance(node, ast.Call):
            self._visit_call(node, scope, env, cls, params, in_loop, ctx)
            return
        if isinstance(node, (ast.Name, ast.Attribute)):
            got = self._resolve(node, env, cls)
            if got is not None and got[0] == "func" and ctx != "neutral":
                self.g.refs.append(_Ref(
                    target=got[1], scope=scope,
                    kind="jit" if ctx == "traced" else "ref",
                    lineno=node.lineno))
            if isinstance(node, ast.Attribute):
                self._visit_expr(node.value, scope, env, cls, params,
                                 in_loop, "plain")
            return
        if isinstance(node, ast.Lambda):
            self._visit_expr(node.body, scope, env, cls, params,
                             in_loop, ctx)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._visit_expr(child, scope, env, cls, params,
                                 in_loop, ctx)
            elif isinstance(child, ast.comprehension):
                self._visit_expr(child.iter, scope, env, cls, params,
                                 in_loop, ctx)
                for cond in child.ifs:
                    self._visit_expr(cond, scope, env, cls, params,
                                     in_loop, ctx)

    def _visit_call(self, node: ast.Call, scope, env, cls, params,
                    in_loop, ctx) -> None:
        callee = self._resolve(node.func, env, cls)
        arg_ctx = "plain" if ctx == "neutral" else ctx
        rec: Optional[CallRecord] = None
        if callee is not None and callee[0] == "wrapper":
            rec = CallRecord(kind="wrapper", node=node, scope=scope,
                             relpath=self.s.relpath, target=callee[1],
                             wrap=callee[2], in_loop=in_loop)
        elif callee is not None and callee[0] == "func":
            self.g.refs.append(_Ref(
                target=callee[1], scope=scope,
                kind="jit" if ctx == "traced" else "call",
                lineno=node.lineno))
            rec = CallRecord(kind="known", node=node, scope=scope,
                             relpath=self.s.relpath, target=callee[1],
                             in_loop=in_loop)
            # a local shim NAMED like a tracing wrapper (e.g. the
            # shard_map compat wrapper in parallel/data_parallel.py)
            # traces its function arguments like the real thing
            if callee[1][1].rsplit(".", 1)[-1] in \
                    _TRACED_ARG_BASENAMES:
                arg_ctx = "traced"
        elif callee is not None and callee[0] == "ext":
            dotted = callee[1]
            base = dotted.rsplit(".", 1)[-1]
            rec = CallRecord(kind="ext", node=node, scope=scope,
                             relpath=self.s.relpath, dotted=dotted,
                             in_loop=in_loop)
            if base in _TRACED_ARG_BASENAMES:
                arg_ctx = "traced"
                if jit_wrap_kind(dotted):
                    self._attach_wrap(node, env, cls)
            elif base in _NEUTRAL_BASENAMES:
                arg_ctx = "neutral"
            elif base == "partial":
                arg_ctx = ctx if ctx != "neutral" else "plain"
                if node.args:
                    first = dotted_of(node.args[0])
                    if first and jit_wrap_kind(first):
                        arg_ctx = "traced"
        else:
            raw = dotted_of(node.func)
            if raw is not None and raw.rsplit(".", 1)[-1] in \
                    _TRACED_ARG_BASENAMES:
                # unresolved but unmistakably named (e.g. a method
                # returning jax.jit objects): still a traced entry
                arg_ctx = "traced"
            if isinstance(node.func, ast.Attribute):
                rec = CallRecord(kind="method", node=node, scope=scope,
                                 relpath=self.s.relpath,
                                 attr=node.func.attr, in_loop=in_loop)
                self._visit_expr(node.func.value, scope, env, cls,
                                 params, in_loop, "plain")
            elif isinstance(node.func, ast.Name):
                # unresolved bare-name call (builtins like float/int,
                # sorted, set): rules match on the raw name
                rec = CallRecord(kind="builtin", node=node, scope=scope,
                                 relpath=self.s.relpath,
                                 dotted=node.func.id, in_loop=in_loop)
        if rec is not None:
            self.g.facts.setdefault(scope, FuncFacts()).records \
                .append(rec)
        if isinstance(node.func, (ast.Call, ast.Lambda, ast.Subscript,
                                  ast.BoolOp, ast.IfExp)):
            # curried/derived callee, e.g. jax.vmap(f)(xs) — the inner
            # expression carries its own references
            self._visit_expr(node.func, scope, env, cls, params,
                             in_loop, "plain")
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            self._visit_expr(arg, scope, env, cls, params, in_loop,
                             arg_ctx)

    def _attach_wrap(self, node: ast.Call, env, cls) -> None:
        """jit(f, ...) call: attach wrap metadata to f for TPL003/004."""
        from .astscan import _wrap_from_call_kwargs
        if not node.args:
            return
        got = self._resolve(node.args[0], env, cls)
        if got is not None and got[0] == "func":
            info = self.g.funcs.get(got[1])
            if info is not None:
                kind = jit_wrap_kind(dotted_of(node.func)) or "jit"
                info.wrappers.append(_wrap_from_call_kwargs(
                    kind, node.lineno, node.keywords))


def scan_package(root: str, package: str = "lightgbm_tpu_torch",
                 exclude: Tuple[str, ...] = ("analysis",),
                 files: Optional[List[str]] = None) -> List[ModuleScan]:
    """Parse every ``*.py`` under ``root`` into ModuleScans.

    ``root`` is the package directory; relpaths are package-relative
    posix paths ("ops/grow.py"). ``exclude`` prunes subpackage names
    (the analyzer does not lint itself).
    """
    scans: List[ModuleScan] = []
    if files is not None:
        targets = [os.path.join(root, f) for f in files]
    else:
        targets = []
        for dirpath, dirnames, filenames in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            parts = [] if rel == "." else rel.split(os.sep)
            if parts and parts[0] in exclude:
                dirnames[:] = []
                continue
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != "__pycache__"
                           and (parts or d not in exclude)]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    targets.append(os.path.join(dirpath, fn))
    for path in targets:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        mod = package + "." + rel[:-3].replace("/", ".")
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        scans.append(ModuleScan(rel, source, mod))
    return scans


def build_callgraph(root: str, package: str = "lightgbm_tpu_torch",
                    files: Optional[List[str]] = None) -> CallGraph:
    return CallGraph(scan_package(root, package=package, files=files))

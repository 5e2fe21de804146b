"""Per-module AST scanning: the port's copy of
``lightgbm_tpu/analysis/astscan.py`` (pure stdlib — importing this never
pulls torch).

One :class:`ModuleScan` per source file records everything the
call-graph builder and the rules need:

- every function/method definition (including nested closures) with its
  dotted qualname (``Grower._split``),
- the import table (local alias -> absolute dotted path),
- module-level aliases (``fn = other_fn``; the JAX package's
  ``jax.jit(...)`` wrappings are still recognized, so the scan of a
  shared source equals the JAX package's),
- ``# tpulint:`` pragmas: ``hot`` (a per-iteration driver: the port's
  TPL002 and TPL009 run over everything it reaches), ``disable=TPLNNN``
  inline suppressions, ``threadsafe <why>`` (TPL008) and
  ``replicated-cond <why>`` (TPL010).

Scanning is purely lexical/structural; resolution across modules
happens in :mod:`~lightgbm_tpu_torch.analysis.callgraph`.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["FuncInfo", "JitWrap", "ModuleScan", "dotted_of",
           "jit_wrap_kind", "literal_int_tuple", "literal_str_tuple"]

#: names that wrap a python function into a traced/compiled entry point.
#: Matched on the *basename* of the resolved dotted path so that local
#: compatibility shims (e.g. parallel/data_parallel.py's ``shard_map``
#: wrapper around the moving jax API) count as tracing wrappers too.
_JIT_BASENAMES = {"jit", "pjit", "shard_map"}

_PRAGMA_RE = re.compile(r"#\s*tpulint:\s*(.+?)\s*$")


@dataclass
class JitWrap:
    """One jit/pjit/shard_map wrapping of a function."""
    kind: str                                   # "jit" | "shard_map"
    lineno: int
    static_argnums: Optional[Tuple[int, ...]] = None
    static_argnames: Optional[Tuple[str, ...]] = None
    donate_argnums: Optional[Tuple[int, ...]] = None


@dataclass
class FuncInfo:
    """A function or method definition."""
    relpath: str                                # "ops/grow.py"
    qual: str                                   # "Class.meth.inner"
    name: str
    lineno: int
    end_lineno: int
    node: ast.AST
    params: Tuple[str, ...]                     # positional-or-kw order
    class_name: Optional[str] = None            # innermost class
    parent_qual: Optional[str] = None           # enclosing function
    decorator_wrap: Optional[JitWrap] = None    # @jax.jit-style
    wrappers: List[JitWrap] = field(default_factory=list)
    is_hot: bool = False                        # "# tpulint: hot"

    @property
    def key(self) -> Tuple[str, str]:
        return (self.relpath, self.qual)


def dotted_of(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None (raw, unresolved
    against the import table — callers resolve the root)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def literal_int_tuple(node: ast.AST) -> Optional[Tuple[int, ...]]:
    """A literal int or tuple-of-ints, else None (dynamic)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) \
                    and isinstance(elt.value, int) \
                    and not isinstance(elt.value, bool):
                out.append(elt.value)
            else:
                return None
        return tuple(out)
    return None


def literal_str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) \
                    and isinstance(elt.value, str):
                out.append(elt.value)
            else:
                return None
        return tuple(out)
    return None


def jit_wrap_kind(dotted: Optional[str]) -> Optional[str]:
    """Classify a resolved dotted callable as a tracing wrapper."""
    if not dotted:
        return None
    base = dotted.rsplit(".", 1)[-1]
    if base not in _JIT_BASENAMES:
        return None
    return "shard_map" if base == "shard_map" else "jit"


def _wrap_from_call_kwargs(kind: str, lineno: int,
                           keywords) -> JitWrap:
    w = JitWrap(kind=kind, lineno=lineno)
    for kw in keywords or ():
        if kw.arg == "static_argnums":
            w.static_argnums = literal_int_tuple(kw.value)
        elif kw.arg == "static_argnames":
            w.static_argnames = literal_str_tuple(kw.value)
        elif kw.arg == "donate_argnums":
            w.donate_argnums = literal_int_tuple(kw.value)
    return w


class ModuleScan:
    """Phase-1 scan of one source file."""

    def __init__(self, relpath: str, source: str, module: str):
        self.relpath = relpath
        self.module = module                    # dotted module name
        # a package __init__ IS its package: relative imports resolve
        # against the module itself, not its parent
        self.is_package = relpath.endswith("__init__.py")
        self.tree = ast.parse(source, filename=relpath)
        self.lines = source.splitlines()
        self.funcs: Dict[str, FuncInfo] = {}
        # class name -> base-class dotted names (raw, unresolved):
        # TPL008 seeds socketserver/http.server request-handler
        # subclasses as thread-side (their do_*/handle methods run on
        # the serving stack's daemon threads, not the main path)
        self.class_bases: Dict[str, Tuple[str, ...]] = {}
        self.imports: Dict[str, str] = {}       # module-level aliases
        # module-level name -> ("func", qual) | ("wrapper", qual, JitWrap)
        self.aliases: Dict[str, tuple] = {}
        # class attr wrappers: (class, attr) -> (target_qual, JitWrap)
        self.attr_wrappers: Dict[Tuple[str, str], tuple] = {}
        self.hot_lines: Set[int] = set()
        self.disable_lines: Dict[int, Set[str]] = {}
        # "# tpulint: threadsafe <why>" — line -> justification text.
        # TPL008 accepts the mark only with a non-empty why (an
        # acceptance without a reason is just a suppressed race).
        self.threadsafe_lines: Dict[int, str] = {}
        # "# tpulint: replicated-cond <why>" — line -> justification.
        # TPL010 accepts a device collective under a traced lax.cond
        # only with a non-empty why naming the replicated-predicate
        # argument (a bare mark is just a suppressed deadlock).
        self.replicated_cond_lines: Dict[int, str] = {}
        self._scan_pragmas()
        self._collect(self.tree, [], [], None)
        self._collect_module_imports()
        self._collect_module_aliases()

    # -- pragmas -------------------------------------------------------
    def _scan_pragmas(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(line)
            if not m:
                continue
            body = m.group(1)
            # marker tokens are read from the FRONT of the pragma body
            # only; the first non-marker token starts the free-text
            # justification (so a justification containing the word
            # "hot" never hot-marks the line)
            for token in body.split():
                if token == "hot":
                    self.hot_lines.add(i)
                elif token.startswith("disable="):
                    rules = {r.strip() for r in
                             token[len("disable="):].split(",") if r}
                    self.disable_lines.setdefault(i, set()).update(rules)
                elif token == "threadsafe":
                    # everything after the marker is the required why
                    why = body.split("threadsafe", 1)[1].strip()
                    self.threadsafe_lines[i] = why
                    break
                elif token == "replicated-cond":
                    why = body.split("replicated-cond", 1)[1].strip()
                    self.replicated_cond_lines[i] = why
                    break
                else:
                    break

    def suppressed(self, rule: str, lineno: int) -> bool:
        """A ``disable=`` pragma on the finding's line or the line
        directly above it suppresses the rule there."""
        for ln in (lineno, lineno - 1):
            if rule in self.disable_lines.get(ln, ()):
                return True
        return False

    # -- defs ----------------------------------------------------------
    def _collect(self, node, quals: List[str], classes: List[str],
                 parent_qual: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self.class_bases[child.name] = tuple(
                    dotted_of(b) or "" for b in child.bases)
                self._collect(child, quals + [child.name],
                              classes + [child.name], parent_qual)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                qual = ".".join(quals + [child.name])
                a = child.args
                params = tuple(p.arg for p in
                               (a.posonlyargs + a.args))
                info = FuncInfo(
                    relpath=self.relpath, qual=qual, name=child.name,
                    lineno=child.lineno,
                    end_lineno=getattr(child, "end_lineno",
                                       child.lineno),
                    node=child, params=params,
                    class_name=classes[-1] if classes else None,
                    parent_qual=parent_qual,
                    decorator_wrap=self._decorator_wrap(child),
                )
                deco_line = min([child.lineno]
                                + [d.lineno for d in
                                   child.decorator_list])
                if self.hot_lines & {child.lineno, child.lineno - 1,
                                     deco_line, deco_line - 1}:
                    info.is_hot = True
                self.funcs[qual] = info
                self._collect(child, quals + [child.name], classes,
                              qual)
            else:
                self._collect(child, quals, classes, parent_qual)

    def _decorator_wrap(self, fn) -> Optional[JitWrap]:
        """``@jax.jit`` / ``@partial(jax.jit, ...)`` / ``@jax.jit(...)``
        decorators. Raw dotted names only — the callgraph re-checks the
        basename rule, which is import-alias-proof in practice because
        jit/pjit/shard_map are never locally renamed to something
        else."""
        for deco in fn.decorator_list:
            kind = jit_wrap_kind(dotted_of(deco))
            if kind:
                return JitWrap(kind=kind, lineno=deco.lineno)
            if isinstance(deco, ast.Call):
                fk = jit_wrap_kind(dotted_of(deco.func))
                if fk:  # @jax.jit(static_argnums=...)
                    return _wrap_from_call_kwargs(fk, deco.lineno,
                                                  deco.keywords)
                base = dotted_of(deco.func) or ""
                if base.rsplit(".", 1)[-1] == "partial" and deco.args:
                    inner = jit_wrap_kind(dotted_of(deco.args[0]))
                    if inner:  # @functools.partial(jax.jit, ...)
                        return _wrap_from_call_kwargs(
                            inner, deco.lineno, deco.keywords)
        return None

    # -- imports -------------------------------------------------------
    def _collect_module_imports(self) -> None:
        for node in ast.walk(self.tree):
            for name, dotted in self.import_bindings(node):
                self.imports.setdefault(name, dotted)

    def import_bindings(self, node) -> List[Tuple[str, str]]:
        """(local name, absolute dotted) pairs introduced by an
        import statement (anywhere — function-local imports included)."""
        out: List[Tuple[str, str]] = []
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".", 1)[0]
                dotted = alias.name if alias.asname else \
                    alias.name.split(".", 1)[0]
                out.append((local, dotted))
        elif isinstance(node, ast.ImportFrom):
            base = self._resolve_from_base(node)
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                dotted = f"{base}.{alias.name}" if base else alias.name
                out.append((local, dotted))
        return out

    def _resolve_from_base(self, node: ast.ImportFrom) -> str:
        if node.level == 0:
            return node.module or ""
        # relative: level 1 = the containing package (the module
        # itself for a package __init__), each further level one up
        parts = self.module.split(".")
        if not self.is_package:
            parts = parts[:-1]
        up = node.level - 1
        if up:
            parts = parts[:-up] if up < len(parts) else []
        if node.module:
            parts = parts + node.module.split(".")
        return ".".join(parts)

    # -- module-level aliases ------------------------------------------
    def _collect_module_aliases(self) -> None:
        for node in self.tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            got = self._wrap_or_func(node.value)
            if got is None:
                continue
            if isinstance(target, ast.Name):
                self.aliases[target.id] = got
        # class-body / method-body `self.x = jax.jit(...)` wrappers
        for info in self.funcs.values():
            if info.class_name is None:
                continue
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Assign) \
                        or len(node.targets) != 1:
                    continue
                t = node.targets[0]
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                got = self._wrap_or_func(node.value)
                if got is not None and got[0] == "wrapper":
                    self.attr_wrappers[(info.class_name, t.attr)] = \
                        (got[1], got[2])

    def _wrap_or_func(self, value: ast.AST):
        """Classify an assignment RHS: a known local function, or a
        jit-wrapping of one (possibly nested in register_jit(...))."""
        if isinstance(value, ast.Name) and value.id in self.funcs:
            return ("func", value.id)
        if isinstance(value, ast.Call):
            base = dotted_of(value.func) or ""
            if base.rsplit(".", 1)[-1] == "register_jit":
                for arg in value.args:
                    inner = self._wrap_or_func(arg)
                    if inner is not None and inner[0] == "wrapper":
                        return inner
                return None
            kind = jit_wrap_kind(base)
            if kind and value.args:
                target = value.args[0]
                if isinstance(target, ast.Name):
                    w = _wrap_from_call_kwargs(kind, value.lineno,
                                               value.keywords)
                    return ("wrapper", target.id, w)
        return None

"""The contract pass: TPL015-TPL018 verify the cross-process plane (the
port's copy of ``lightgbm_tpu/analysis/rules_contract.py``).

The fleet's only shared language is stringly-typed — JSONL
``{"event": ...}`` records, metrics-registry family names,
``LIGHTGBM_TPU_*`` env vars, and fault-kind strings.  These four
rules check every emission, bump, read, and injection site in the
package against the single-source registries in ``obs/schemas.py``
(literal-evaled straight out of the scanned tree's AST, so fixture
and mutation runs check THEIR OWN copy, never the installed one).

Pure stdlib, like the rest of the AST pass: the registries are
declared as pure literals exactly so this module never has to import
the package it is linting.

- **TPL015** event contract: every ``{"event": X}`` dict literal
  must emit a declared event, with no undeclared keys and (absent a
  ``**spread``) no missing required keys; consumers — any function
  that reads ``ev["event"]``/``ev.get("event")`` — may only compare
  against declared event names and only reference declared keys.
- **TPL016** metrics contract: every ``registry.counter/gauge/
  histogram`` / ``bump_counter`` family must be declared with the
  matching kind and label set; declared-but-never-bumped families
  are findings.
- **TPL017** env contract: every ``LIGHTGBM_TPU_*`` name in the
  package must be declared, and a read site claiming a literal
  default must claim exactly the declared one — two sites
  disagreeing on a default can never both pass.
- **TPL018** fault contract: literal ``_KNOWN_KINDS`` /
  ``_ONE_SHOT_KINDS`` tuples, ``record_fault_event``-family call
  sites and ``FaultPlan`` gate calls must all agree with the declared
  kind registry.

The JAX package's rules also hold the registries against its docs
(``docs/OBSERVABILITY.md``, the ``docs/RESILIENCE.md`` chaos matrix);
the port has no docs of its own, so its rules read its registry alone.

Whole-package aggregate checks (declared-but-never-X)
anchor on ``obs/schemas.py`` and only run when that file is in the
reporting scope — a ``--changed`` slice that never touched the
registry cannot produce (or --strict-fail on) them.
"""

from __future__ import annotations

import ast
import re
from typing import (Any, Dict, FrozenSet, Iterator, List, Optional,
                    Set, Tuple)

from .astscan import ModuleScan, dotted_of, literal_str_tuple
from .rules import Finding, LintContext, Rule

__all__ = ["CONTRACT_RULES", "SCHEMAS_RELPATH", "load_contracts"]

#: where the registries live, package-relative (fixture trees carry
#: their own mini copy under the same tail path)
SCHEMAS_RELPATH = "obs/schemas.py"

#: the five registry dicts the loader literal-evals
_REGISTRY_NAMES = ("EVENTS", "METRICS", "EXPORT_FAMILIES", "ENV_VARS",
                   "FAULT_KINDS", "FAULT_EVENT_KINDS")

_ENV_NAME_RE = re.compile(r"^LIGHTGBM_TPU_[A-Z0-9_]+$")


class Contracts:
    """The literal-evaled registries plus anchor linenos."""

    def __init__(self, relpath: str):
        self.relpath = relpath
        self.events: Dict[str, dict] = {}
        self.metrics: Dict[str, dict] = {}
        self.export_families: Dict[str, dict] = {}
        self.env_vars: Dict[str, dict] = {}
        self.fault_kinds: Dict[str, dict] = {}
        self.fault_event_kinds: Dict[str, dict] = {}
        self.linenos: Dict[str, int] = {}      # registry name -> line
        self.anchor: Optional[ast.AST] = None  # first registry assign

    @property
    def all_event_keys(self) -> FrozenSet[str]:
        keys: Set[str] = set()
        for spec in self.events.values():
            keys.update(spec.get("required", ()))
            keys.update(spec.get("optional", ()))
        return frozenset(keys)

    def anchor_node(self, registry: str) -> ast.AST:
        node = ast.Module(body=[], type_ignores=[])
        node.lineno = self.linenos.get(registry, 1)
        node.col_offset = 0
        return node


def load_contracts(ctx: LintContext) -> Optional[Contracts]:
    """Find and literal-eval ``obs/schemas.py`` in the scanned tree.

    Returns None (contract rules no-op) when the tree carries no
    registry module — single-file fixture slices for the other rules
    must not drown in contract findings.
    """
    cache = getattr(ctx, "_contracts_cache", _MISSING)
    if cache is not _MISSING:
        return cache
    scan = _schemas_scan(ctx)
    out: Optional[Contracts] = None
    if scan is not None:
        out = Contracts(scan.relpath)
        for node in scan.tree.body:
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if name not in _REGISTRY_NAMES:
                continue
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                # non-literal registry: the single-source contract is
                # itself broken; surface it through TPL015
                out.linenos.setdefault(name, node.lineno)
                continue
            out.linenos[name] = node.lineno
            if out.anchor is None:
                out.anchor = node
            setattr(out, _ATTR_OF[name], value)
    ctx._contracts_cache = out            # type: ignore[attr-defined]
    return out


_MISSING = object()
_ATTR_OF = {"EVENTS": "events", "METRICS": "metrics",
            "EXPORT_FAMILIES": "export_families",
            "ENV_VARS": "env_vars", "FAULT_KINDS": "fault_kinds",
            "FAULT_EVENT_KINDS": "fault_event_kinds"}


def _schemas_scan(ctx: LintContext) -> Optional[ModuleScan]:
    for rel, scan in ctx.scans.items():
        if rel == SCHEMAS_RELPATH or rel.endswith("/" + SCHEMAS_RELPATH):
            return scan
    return None


def _site_scans(ctx: LintContext) -> Iterator[ModuleScan]:
    """Scans the per-site checks REPORT over: the rule scope minus
    the registry module itself (its dict keys are the declarations,
    not use sites)."""
    for scan in ctx.scoped_scans():
        if not _is_schemas(scan.relpath):
            yield scan


def _all_scans(ctx: LintContext) -> Iterator[ModuleScan]:
    """Scans the aggregate COLLECTION passes cover: everything parsed
    (a ``--changed`` run still parses the whole package), minus the
    registry module."""
    for rel in sorted(ctx.scans):
        if not _is_schemas(rel):
            yield ctx.scans[rel]


def _is_schemas(relpath: str) -> bool:
    return relpath == SCHEMAS_RELPATH \
        or relpath.endswith("/" + SCHEMAS_RELPATH)


def _walk_skipping_nested(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested defs
    (they are analyzed as their own functions)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(child))


def _func_bodies(scan: ModuleScan) -> Iterator[Tuple[str, ast.AST]]:
    for qual, info in scan.funcs.items():
        yield qual, info.node


def _key_access(node: ast.AST) -> Optional[Tuple[str, str, ast.AST]]:
    """``(var, key, node)`` for ``var["key"]`` or ``var.get("key"...)``
    on a bare Name, else None."""
    if isinstance(node, ast.Subscript) \
            and isinstance(node.value, ast.Name) \
            and isinstance(node.slice, ast.Constant) \
            and isinstance(node.slice.value, str):
        return (node.value.id, node.slice.value, node)
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" \
            and isinstance(node.func.value, ast.Name) \
            and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return (node.func.value.id, node.args[0].value, node)
    return None


def _event_access(node: ast.AST) -> bool:
    """Is ``node`` an ``<expr>["event"]`` / ``<expr>.get("event")``
    read on ANY receiver expression?"""
    if isinstance(node, ast.Subscript) \
            and isinstance(node.slice, ast.Constant) \
            and node.slice.value == "event":
        return True
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and bool(node.args)
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "event")


# ---------------------------------------------------------------------
class EventContract(Rule):
    """TPL015: emitted and consumed JSONL events match the registry."""

    id = "TPL015"
    title = "JSONL event outside the declared schema registry"

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        c = load_contracts(ctx)
        if c is None:
            return
        if not c.events and "EVENTS" in c.linenos:
            yield self._finding(
                ctx, c.relpath, c.anchor_node("EVENTS"), "EVENTS",
                "EVENTS is not a pure literal dict — the contract "
                "lint cannot read it (keep the registry "
                "literal-evalable)")
            return
        for scan in _site_scans(ctx):
            yield from self._check_emissions(ctx, scan, c)
            yield from self._check_consumers(ctx, scan, c)
        if _is_schemas_in_scope(ctx):
            yield from self._aggregates(ctx, c)

    # -- emission sites ------------------------------------------------
    def _check_emissions(self, ctx: LintContext, scan: ModuleScan,
                         c: Contracts) -> Iterator[Finding]:
        for name, keys, spread, node in _emissions(scan.tree):
            spec = c.events.get(name)
            if spec is None:
                yield self._finding(
                    ctx, scan.relpath, node, f"event:{name}",
                    f'dict literal emits undeclared event "{name}" — '
                    f"declare it in {SCHEMAS_RELPATH} EVENTS (or fix "
                    f"the name)")
                continue
            required = set(spec.get("required", ()))
            allowed = required | set(spec.get("optional", ()))
            extra = sorted(keys - allowed)
            if extra:
                yield self._finding(
                    ctx, scan.relpath, node, f"event:{name}:keys",
                    f'"{name}" event emits undeclared key(s) '
                    f"{', '.join(extra)} — declare them in "
                    f"{SCHEMAS_RELPATH} EVENTS[{name!r}]")
            if not spread:
                missing = sorted(required - keys)
                if missing:
                    yield self._finding(
                        ctx, scan.relpath, node,
                        f"event:{name}:missing",
                        f'"{name}" event omits required key(s) '
                        f"{', '.join(missing)} (no **spread fills "
                        f"them)")

    # -- consumer sites ------------------------------------------------
    def _check_consumers(self, ctx: LintContext, scan: ModuleScan,
                         c: Contracts) -> Iterator[Finding]:
        union_keys = c.all_event_keys
        for qual, fnode in _func_bodies(scan):
            accesses: List[Tuple[str, str, ast.AST]] = []
            compares: List[Tuple[str, ast.AST]] = []
            for node in _walk_skipping_nested(fnode):
                acc = _key_access(node)
                if acc is not None:
                    accesses.append(acc)
                if isinstance(node, ast.Compare) \
                        and _event_access(node.left):
                    for comp in node.comparators:
                        for s in _const_strs(comp):
                            compares.append((s, node))
            event_vars = {var for var, key, _ in accesses
                          if key == "event"}
            for name, node in compares:
                if name not in c.events:
                    yield self._finding(
                        ctx, scan.relpath, node, f"consumes:{name}",
                        f'consumer compares against undeclared event '
                        f'name "{name}" — no declared emitter '
                        f"produces it", func=qual)
            seen: Set[str] = set()
            for var, key, node in accesses:
                # leading-underscore keys are consumer-local
                # annotations (e.g. load_spans' "_stream" clock-domain
                # tag), never wire keys — exempt by convention
                if var not in event_vars or key == "event" \
                        or key.startswith("_") \
                        or key in union_keys or key in seen:
                    continue
                seen.add(key)
                yield self._finding(
                    ctx, scan.relpath, node, f"consumes-key:{key}",
                    f'consumer references key "{key}" that no '
                    f"declared event emits — dead read or schema "
                    f"drift", func=qual)

    # -- whole-tree aggregates ----------------------------------------
    def _aggregates(self, ctx: LintContext,
                    c: Contracts) -> Iterator[Finding]:
        emitted: Set[str] = set()
        for scan in _all_scans(ctx):
            for name, _, _, _ in _emissions(scan.tree):
                emitted.add(name)
        for name in sorted(set(c.events) - emitted):
            yield self._finding(
                ctx, c.relpath, c.anchor_node("EVENTS"),
                f"unemitted:{name}",
                f'event "{name}" is declared but no dict literal in '
                f"the package emits it — stale registry entry")


def _is_schemas_in_scope(ctx: LintContext) -> bool:
    return any(_is_schemas(rel) for rel in ctx.scope)


def _const_strs(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: List[str] = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) \
                    and isinstance(elt.value, str):
                out.append(elt.value)
        return out
    return []


def _emissions(tree: ast.AST) -> Iterator[
        Tuple[str, Set[str], bool, ast.AST]]:
    """``(event_name, literal_keys, has_spread, node)`` for every
    ``{"event": "X", ...}`` dict literal."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        name: Optional[str] = None
        keys: Set[str] = set()
        spread = False
        for k, v in zip(node.keys, node.values):
            if k is None:                     # **spread
                spread = True
                continue
            if isinstance(k, ast.Constant) \
                    and isinstance(k.value, str):
                keys.add(k.value)
                if k.value == "event" \
                        and isinstance(v, ast.Constant) \
                        and isinstance(v.value, str):
                    name = v.value
        if name is not None:
            yield name, keys, spread, node


# ---------------------------------------------------------------------
class MetricsContract(Rule):
    """TPL016: registry bumps match the declared metric families."""

    id = "TPL016"
    title = "metrics-registry family outside the declared registry"

    _METHODS = {"counter": "counter", "gauge": "gauge",
                "histogram": "histogram"}

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        c = load_contracts(ctx)
        if c is None:
            return
        for scan in _site_scans(ctx):
            if scan.relpath == "obs/registry.py":
                continue      # the implementation takes names as args
            yield from self._check_sites(ctx, scan, c, report=True)
        if _is_schemas_in_scope(ctx):
            yield from self._aggregates(ctx, c)

    def _aggregates(self, ctx: LintContext,
                    c: Contracts) -> Iterator[Finding]:
        bumped: Set[str] = set()
        for scan in _all_scans(ctx):
            if scan.relpath == "obs/registry.py":
                continue
            for f in self._check_sites(ctx, scan, c, report=False,
                                       bumped=bumped):
                pass
        for name in sorted(set(c.metrics) - bumped):
            yield self._finding(
                ctx, c.relpath, c.anchor_node("METRICS"),
                f"unbumped:{name}",
                f'metric family "{name}" is declared but never '
                f"bumped anywhere in the package — stale registry "
                f"entry")

    def _check_sites(self, ctx: LintContext, scan: ModuleScan,
                     c: Contracts, report: bool,
                     bumped: Optional[Set[str]] = None
                     ) -> Iterator[Finding]:
        module_consts = _module_literals(scan.tree)
        bump_names = _bump_aliases(scan)
        for qual, fnode in list(_func_bodies(scan)) \
                + [("<module>", scan.tree)]:
            loops = _loop_bindings(fnode, module_consts)
            for node in (_walk_skipping_nested(fnode)
                         if qual != "<module>" else _module_walk(fnode)):
                if not isinstance(node, ast.Call):
                    continue
                kind, name_node, labels, starred = \
                    self._match_call(node, bump_names)
                if kind is None:
                    continue
                for f in self._check_one(ctx, scan, c, qual, node,
                                         kind, name_node, labels,
                                         starred, loops, bumped):
                    if report:
                        yield f

    def _match_call(self, node: ast.Call, bump_names: Set[str]):
        """(kind, name_node, label_names, has_starred) or Nones."""
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in self._METHODS \
                and node.args:
            labels = {kw.arg for kw in node.keywords}
            return (self._METHODS[f.attr], node.args[0],
                    labels - {None}, None in labels)
        if isinstance(f, ast.Name) and f.id in bump_names \
                and node.args:
            labels = {kw.arg for kw in node.keywords}
            return ("counter", node.args[0], labels - {None},
                    None in labels)
        return (None, None, set(), False)

    def _check_one(self, ctx, scan, c, qual, node, kind, name_node,
                   labels, starred, loops, bumped) -> List[Finding]:
        names = _metric_names(name_node, loops)
        out: List[Finding] = []
        if names is None:
            # dynamic, unresolvable: only a finding when the receiver
            # is unmistakably the metrics registry (np.histogram &co
            # fall through here with non-str first args)
            dotted = dotted_of(node.func) or ""
            if "registry" in dotted.split("."):
                out.append(self._finding(
                    ctx, scan.relpath, node, "metric:<dynamic>",
                    "metric family name is dynamic and unresolvable "
                    "— use a literal (or an inline literal loop "
                    "tuple) so the contract lint can check it",
                    func=qual))
            return out
        prefix_match = isinstance(name_node, ast.JoinedStr)
        if prefix_match:
            resolved = [m for m in c.metrics if any(
                m.startswith(p) for p in names)]
            if not resolved:
                out.append(self._finding(
                    ctx, scan.relpath, node,
                    f"metric:{'|'.join(sorted(names))}*",
                    f"f-string metric name matches no declared "
                    f"family (literal prefix "
                    f"{', '.join(sorted(names))})", func=qual))
                return out
            names = resolved
        for name in sorted(set(names)):
            spec = c.metrics.get(name)
            if spec is None:
                out.append(self._finding(
                    ctx, scan.relpath, node, f"metric:{name}",
                    f'bump of undeclared metric family "{name}" — '
                    f"declare it in {SCHEMAS_RELPATH} METRICS",
                    func=qual))
                continue
            if bumped is not None:
                bumped.add(name)
            if spec.get("kind") != kind:
                out.append(self._finding(
                    ctx, scan.relpath, node, f"metric:{name}:kind",
                    f'"{name}" is declared a {spec.get("kind")} but '
                    f"bumped as a {kind}", func=qual))
            declared_labels = set(spec.get("labels", ()))
            if not starred and not prefix_match \
                    and labels != declared_labels:
                out.append(self._finding(
                    ctx, scan.relpath, node, f"metric:{name}:labels",
                    f'"{name}" bumped with labels '
                    f"{{{', '.join(sorted(labels)) or ''}}} but "
                    f"declared with "
                    f"{{{', '.join(sorted(declared_labels)) or ''}}}",
                    func=qual))
        return out


def _module_walk(tree: ast.AST) -> Iterator[ast.AST]:
    """Module statements outside any function body."""
    stack = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _module_literals(tree: ast.AST) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def _bump_aliases(scan: ModuleScan) -> Set[str]:
    """Local names bound to obs.registry.bump_counter."""
    out = {"bump_counter"}
    for local, dotted in scan.imports.items():
        if dotted.endswith("bump_counter"):
            out.add(local)
    return out


def _loop_bindings(fnode: ast.AST,
                   module_consts: Dict[str, Any]
                   ) -> Dict[str, Set[str]]:
    """``for a, b in (("x", "y"), ...):`` -> {"a": {"x"}, "b": {"y"}}
    — how elastic.py names its per-sample gauge families."""
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(fnode):
        if not isinstance(node, ast.For):
            continue
        try:
            rows = ast.literal_eval(node.iter)
        except ValueError:
            rows = module_consts.get(node.iter.id) \
                if isinstance(node.iter, ast.Name) else None
        if not isinstance(rows, (tuple, list)) or not rows:
            continue
        targets = node.target.elts \
            if isinstance(node.target, ast.Tuple) else [node.target]
        for i, tgt in enumerate(targets):
            if not isinstance(tgt, ast.Name):
                continue
            vals = set()
            for row in rows:
                cell = row[i] if isinstance(row, (tuple, list)) \
                    and i < len(row) else row
                if isinstance(cell, str):
                    vals.add(cell)
            if vals:
                out.setdefault(tgt.id, set()).update(vals)
    return out


def _metric_names(name_node: ast.AST,
                  loops: Dict[str, Set[str]]
                  ) -> Optional[List[str]]:
    """Candidate family names of a bump's first argument: a literal
    str, an f-string (returns its literal PREFIXES for prefix
    matching), or a loop-bound name over a literal tuple table.
    None: dynamic, unresolvable."""
    if isinstance(name_node, ast.Constant):
        return [name_node.value] \
            if isinstance(name_node.value, str) else None
    if isinstance(name_node, ast.JoinedStr):
        prefix = ""
        for part in name_node.values:
            if isinstance(part, ast.Constant) \
                    and isinstance(part.value, str):
                prefix += part.value
            else:
                break
        return [prefix] if prefix else None
    if isinstance(name_node, ast.Name) and name_node.id in loops:
        return sorted(loops[name_node.id])
    return None


# ---------------------------------------------------------------------
class EnvContract(Rule):
    """TPL017: LIGHTGBM_TPU_* reads resolve to declared entries."""

    id = "TPL017"
    title = "LIGHTGBM_TPU_* env var outside the declared registry"

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        c = load_contracts(ctx)
        if c is None:
            return
        for scan in _site_scans(ctx):
            yield from self._check_sites(ctx, scan, c)
        if _is_schemas_in_scope(ctx):
            yield from self._aggregates(ctx, c)

    def _check_sites(self, ctx: LintContext, scan: ModuleScan,
                     c: Contracts) -> Iterator[Finding]:
        seen_undeclared: Set[Tuple[str, int]] = set()
        for node in ast.walk(scan.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and _ENV_NAME_RE.match(node.value) \
                    and node.value not in c.env_vars:
                key = (node.value, node.lineno)
                if key not in seen_undeclared:
                    seen_undeclared.add(key)
                    yield self._finding(
                        ctx, scan.relpath, node,
                        f"env:{node.value}",
                        f"undeclared env var {node.value} — declare "
                        f"it in {SCHEMAS_RELPATH} ENV_VARS",)
            if not isinstance(node, ast.Call):
                continue
            claimed = _env_default_claim(node)
            if claimed is None:
                continue
            name, default, site = claimed
            spec = c.env_vars.get(name)
            if spec is None:
                continue              # already reported as undeclared
            declared = spec.get("default")
            if declared is None or str(default) != str(declared):
                want = "no default (read bare and handle None at " \
                       "the site)" if declared is None \
                    else f"the declared default {declared!r}"
                yield self._finding(
                    ctx, scan.relpath, site, f"env:{name}:default",
                    f"{name} read with default {default!r} but the "
                    f"registry declares {want} — two sites "
                    f"disagreeing on a default can never both pass")

    def _aggregates(self, ctx: LintContext,
                    c: Contracts) -> Iterator[Finding]:
        referenced: Set[str] = set()
        for scan in _all_scans(ctx):
            for node in ast.walk(scan.tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str) \
                        and _ENV_NAME_RE.match(node.value):
                    referenced.add(node.value)
        for name in sorted(set(c.env_vars) - referenced):
            yield self._finding(
                ctx, c.relpath, c.anchor_node("ENV_VARS"),
                f"unread:{name}",
                f"env var {name} is declared but never referenced "
                f"anywhere in the package — stale registry entry")


def _env_default_claim(node: ast.Call
                       ) -> Optional[Tuple[str, Any, ast.AST]]:
    """``(name, default, node)`` when the call is
    ``<expr>.get/setdefault("LIGHTGBM_TPU_X", <literal>)`` with a
    non-None literal default."""
    f = node.func
    if not (isinstance(f, ast.Attribute)
            and f.attr in ("get", "setdefault")
            and len(node.args) >= 2
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and _ENV_NAME_RE.match(node.args[0].value)
            and isinstance(node.args[1], ast.Constant)
            and node.args[1].value is not None):
        return None
    return (node.args[0].value, node.args[1].value, node)


# ---------------------------------------------------------------------
class FaultContract(Rule):
    """TPL018: fault kinds agree across plan, strip list and events
    (the registry alone: the port has no chaos-matrix doc)."""

    id = "TPL018"
    title = "fault kind outside the declared kind registry"

    #: writer call names -> index of the kind argument
    _WRITERS = {"append_fault_event": 1, "record_fault_event": 0,
                "_record_fault": 0, "_fault": 0}
    #: FaultPlan gate methods whose first arg is an injectable kind
    _GATES = ("fires", "take", "iters")

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        c = load_contracts(ctx)
        if c is None:
            return
        legal = set(c.fault_kinds) | set(c.fault_event_kinds)
        one_shot = {k for k, spec in c.fault_kinds.items()
                    if spec.get("one_shot")}
        for scan in _site_scans(ctx):
            yield from self._check_literals(ctx, scan, c, one_shot)
            yield from self._check_calls(ctx, scan, c, legal)

    def _check_literals(self, ctx: LintContext, scan: ModuleScan,
                        c: Contracts,
                        one_shot: Set[str]) -> Iterator[Finding]:
        """Hand-maintained literal kind tuples (forks, fixtures) must
        match the registry; the shipped tree derives them from
        obs/schemas.py instead."""
        for node in scan.tree.body:
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            lit = literal_str_tuple(node.value)
            if lit is None:
                continue
            if name == "_KNOWN_KINDS" \
                    and set(lit) != set(c.fault_kinds):
                drift = sorted(set(lit) ^ set(c.fault_kinds))
                yield self._finding(
                    ctx, scan.relpath, node, "fault-kinds",
                    f"literal _KNOWN_KINDS disagrees with "
                    f"{SCHEMAS_RELPATH} FAULT_KINDS on "
                    f"{', '.join(drift)} — derive it from the "
                    f"registry (injectable_fault_kinds())")
            if name == "_ONE_SHOT_KINDS" and set(lit) != one_shot:
                drift = sorted(set(lit) ^ one_shot)
                yield self._finding(
                    ctx, scan.relpath, node, "one-shot-kinds",
                    f"literal _ONE_SHOT_KINDS disagrees with the "
                    f"one_shot classification in {SCHEMAS_RELPATH} "
                    f"on {', '.join(drift)} — derive it from the "
                    f"registry (one_shot_fault_kinds())")

    def _check_calls(self, ctx: LintContext, scan: ModuleScan,
                     c: Contracts,
                     legal: Set[str]) -> Iterator[Finding]:
        for node in ast.walk(scan.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = node.func.attr \
                if isinstance(node.func, ast.Attribute) \
                else (node.func.id
                      if isinstance(node.func, ast.Name) else None)
            if fname in self._WRITERS:
                idx = self._WRITERS[fname]
                kinds = _const_strs_deep(node.args[idx]) \
                    if len(node.args) > idx else []
                universe, where = legal, "FAULT_EVENT_KINDS"
            elif fname in self._GATES \
                    and isinstance(node.func, ast.Attribute) \
                    and node.args:
                kinds = _const_strs_deep(node.args[0])
                universe, where = set(c.fault_kinds), "FAULT_KINDS"
            else:
                continue
            for kind in kinds:
                if kind not in universe:
                    yield self._finding(
                        ctx, scan.relpath, node,
                        f"fault-kind:{kind}",
                        f'undeclared fault kind "{kind}" — declare '
                        f"it in {SCHEMAS_RELPATH} {where} (or fix "
                        f"the string)")


def _const_strs_deep(node: ast.AST) -> List[str]:
    """Every plausible kind literal inside an argument expression
    (plain constant, IfExp arms, tuples)."""
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) \
                and isinstance(sub.value, str) \
                and re.match(r"^[a-z][a-z0-9_]*$", sub.value):
            out.append(sub.value)
    return out


CONTRACT_RULES: List[Rule] = [EventContract(), MetricsContract(),
                              EnvContract(), FaultContract()]

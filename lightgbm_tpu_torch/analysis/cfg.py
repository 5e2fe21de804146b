"""Per-function control-flow graphs + path-sensitive dataflow.

The statement-level rules (TPL001-TPL006) answer "does this call occur
in this function"; the distributed-safety rules (TPL007/TPL008) need
"on *which paths* does it occur, and what is guaranteed to hold there".
This module builds one small CFG per function definition and solves two
forward dataflow problems over it:

**Guard pins** — for every statement, the set of branch decisions
``(test_expr, polarity)`` that hold on *every* path from the function
entry to it (meet = intersection over incoming edges). Because the meet
runs over the CFG rather than the lexical nesting, an early exit
propagates its condition onto the code *after* the branch::

    if process_index() == 0:
        return                    # this arm always diverts
    host_allgather(...)           # pins: (process_index()==0, False)

while a fall-through arm correctly contributes nothing::

    if process_index() == 0:
        payload = serialize()     # falls through
    host_broadcast_bytes(payload) # pins: {} — every rank reaches it

which is exactly the distinction between a rank-divergent collective
(deadlock) and the idiomatic rank-dependent *argument* (fine). ``for``
loops pin their body on the iterable (a rank-dependent iterable means a
rank-dependent trip count — every extra iteration is an extra
collective some ranks never join).

**Held locks** — for every statement, the set of lock expressions
guaranteed held there: lexical ``with lock:`` scopes plus a forward
``.acquire()``/``.release()`` dataflow (meet = intersection), so
TPL008's "write and read share a common lock" check is a CFG question,
not a syntactic one.

Each statement also carries its exception context (``in_except`` /
``in_finally``): code in handlers runs only on ranks that hit the
exception — a collective there is rank-divergent by construction.

The port's copy of ``lightgbm_tpu/analysis/cfg.py``, unchanged in
what it computes. Pure stdlib; importing this never imports torch.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .astscan import dotted_of

__all__ = ["FunctionCFG", "UnitInfo", "Pin"]

#: one guaranteed branch decision: (test expression, polarity). For
#: ``for`` bodies the "test" is the iterable and polarity is True.
Pin = Tuple[ast.expr, bool]

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


def looks_like_lock(expr: ast.expr) -> Optional[str]:
    """The dotted name of a lock-ish context/target expression
    (``self._lock``, ``_state_lock``, ``threading.Lock()``), else
    None. Shared by the CFG lock dataflow and TPL006/TPL008."""
    d = dotted_of(expr)
    if d is None:
        if isinstance(expr, ast.Call):
            f = dotted_of(expr.func) or ""
            if f.rsplit(".", 1)[-1] in _LOCK_CTORS:
                return f  # anonymous with Lock(): — named by ctor
        return None
    last = d.rsplit(".", 1)[-1].lower()
    if "lock" in last or "mutex" in last:
        return d
    return None


@dataclass
class UnitInfo:
    """Everything the flow rules need to know about one statement."""
    stmt: ast.stmt
    pins: List[Pin]
    in_except: bool
    in_finally: bool
    held_locks: FrozenSet[str]
    reachable: bool = True


@dataclass
class _Block:
    bid: int
    units: List[int] = field(default_factory=list)
    # (succ block id, optional pin added on this edge)
    succs: List[Tuple[int, Optional[Tuple[int, bool]]]] = \
        field(default_factory=list)
    in_except: bool = False
    in_finally: bool = False
    with_locks: FrozenSet[str] = frozenset()


class FunctionCFG:
    """CFG + solved dataflow for one ``ast.FunctionDef`` body. Nested
    function/class definitions are opaque single statements (each
    nested def gets its own FunctionCFG from the rule)."""

    def __init__(self, fn_node: ast.AST):
        self.fn_node = fn_node
        self._blocks: List[_Block] = []
        self._units: List[Tuple[ast.stmt, int]] = []  # (stmt, block id)
        self._node_unit: Dict[int, int] = {}          # id(node) -> uid
        self._pin_nodes: Dict[int, ast.expr] = {}     # id -> test expr
        entry = self._new_block()
        self.entry = entry.bid
        exit_block = self._new_block()
        self.exit = exit_block.bid
        body = getattr(fn_node, "body", [])
        ctx = _Ctx(loop_header=None, loop_exit=None,
                   in_except=False, in_finally=False,
                   with_locks=frozenset())
        tail = self._build_body(body, entry.bid, ctx)
        if tail is not None:
            self._edge(tail, self.exit)
        self._guards_in = self._solve_guards()
        self._locks_in = self._solve_locks()
        # per-unit precision: a lock.acquire() earlier in the SAME
        # block counts as held for the statements after it
        self._unit_locks: Dict[int, FrozenSet[str]] = {}
        for b in self._blocks:
            cur = self._locks_in[b.bid] or frozenset()
            for uid in b.units:
                self._unit_locks[uid] = cur
                cur = self._transfer_locks_one(uid, cur)

    # -- construction --------------------------------------------------
    def _new_block(self, *, in_except=False, in_finally=False,
                   with_locks: FrozenSet[str] = frozenset()) -> _Block:
        b = _Block(bid=len(self._blocks), in_except=in_except,
                   in_finally=in_finally, with_locks=with_locks)
        self._blocks.append(b)
        return b

    def _edge(self, src: int, dst: int,
              pin: Optional[Pin] = None) -> None:
        key = None
        if pin is not None:
            key = (id(pin[0]), pin[1])
            self._pin_nodes[id(pin[0])] = pin[0]
        self._blocks[src].succs.append((dst, key))

    def _add_unit(self, block: int, stmt: ast.stmt,
                  index_nodes: Optional[List[ast.AST]] = None) -> int:
        uid = len(self._units)
        self._units.append((stmt, block))
        self._blocks[block].units.append(uid)
        for root in (index_nodes if index_nodes is not None
                     else [stmt]):
            for sub in ast.walk(root):
                self._node_unit.setdefault(id(sub), uid)
        return uid

    def _spawn(self, ctx: "_Ctx", **over) -> _Block:
        return self._new_block(
            in_except=over.get("in_except", ctx.in_except),
            in_finally=over.get("in_finally", ctx.in_finally),
            with_locks=over.get("with_locks", ctx.with_locks))

    def _build_body(self, stmts, cur: Optional[int],
                    ctx: "_Ctx") -> Optional[int]:
        """Append ``stmts`` to block ``cur``; return the open block at
        the end, or None when every path diverted (return/raise/...)."""
        for stmt in stmts:
            if cur is None:
                # unreachable code after a divert: still index it (the
                # rules must be able to look any node up) in a fresh,
                # edgeless block

                cur = self._spawn(ctx).bid
            cur = self._build_stmt(stmt, cur, ctx)
        return cur

    def _build_stmt(self, stmt: ast.stmt, cur: int,
                    ctx: "_Ctx") -> Optional[int]:
        if isinstance(stmt, ast.If):
            self._add_unit(cur, stmt, [stmt.test])
            after = self._spawn(ctx)
            body_b = self._spawn(ctx)
            self._edge(cur, body_b.bid, (stmt.test, True))
            body_tail = self._build_body(stmt.body, body_b.bid, ctx)
            if body_tail is not None:
                self._edge(body_tail, after.bid)
            if stmt.orelse:
                else_b = self._spawn(ctx)
                self._edge(cur, else_b.bid, (stmt.test, False))
                else_tail = self._build_body(stmt.orelse, else_b.bid,
                                             ctx)
                if else_tail is not None:
                    self._edge(else_tail, after.bid)
            else:
                self._edge(cur, after.bid, (stmt.test, False))
            return after.bid if self._blocks[after.bid].succs or \
                self._has_preds(after.bid) else None
        if isinstance(stmt, ast.While):
            header = self._spawn(ctx)
            self._edge(cur, header.bid)
            self._add_unit(header.bid, stmt, [stmt.test])
            after = self._spawn(ctx)
            body_b = self._spawn(ctx)
            self._edge(header.bid, body_b.bid, (stmt.test, True))
            # the else clause runs ONLY on normal exhaustion, never on
            # break — it needs its own block off the header's false
            # edge, with break paths joining after it
            exhausted = after
            if stmt.orelse:
                exhausted = self._spawn(ctx)
            self._edge(header.bid, exhausted.bid, (stmt.test, False))
            inner = ctx.replace(loop_header=header.bid,
                                loop_exit=after.bid)
            body_tail = self._build_body(stmt.body, body_b.bid, inner)
            if body_tail is not None:
                self._edge(body_tail, header.bid)
            if stmt.orelse:
                else_tail = self._build_body(stmt.orelse,
                                             exhausted.bid, ctx)
                if else_tail is not None:
                    self._edge(else_tail, after.bid)
            return after.bid
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._add_unit(cur, stmt, [stmt.target, stmt.iter])
            header = self._spawn(ctx)
            self._edge(cur, header.bid)
            after = self._spawn(ctx)
            body_b = self._spawn(ctx)
            # body executes a data-dependent number of times: pin it on
            # the iterable (rank-dependent iterable = rank-dependent
            # collective count). The after-block is unpinned — the loop
            # may run zero times but the exit is always reached.
            self._edge(header.bid, body_b.bid, (stmt.iter, True))
            exhausted = after
            if stmt.orelse:
                exhausted = self._spawn(ctx)
            self._edge(header.bid, exhausted.bid)
            inner = ctx.replace(loop_header=header.bid,
                                loop_exit=after.bid)
            body_tail = self._build_body(stmt.body, body_b.bid, inner)
            if body_tail is not None:
                self._edge(body_tail, header.bid)
            if stmt.orelse:
                else_tail = self._build_body(stmt.orelse,
                                             exhausted.bid, ctx)
                if else_tail is not None:
                    self._edge(else_tail, after.bid)
            return after.bid
        if isinstance(stmt, ast.Try):
            handlers = []
            for h in stmt.handlers:
                hb = self._spawn(ctx, in_except=True)
                # an exception can fire at any point of the try body;
                # the guaranteed state there is the state at try entry
                self._edge(cur, hb.bid)
                handlers.append((h, hb))
            after = self._spawn(ctx)
            body_b = self._spawn(ctx)
            self._edge(cur, body_b.bid)
            inner = ctx
            body_tail = self._build_body(stmt.body, body_b.bid, inner)
            if stmt.orelse and body_tail is not None:
                body_tail = self._build_body(stmt.orelse, body_tail,
                                             inner)
            exits = []
            if body_tail is not None:
                exits.append(body_tail)
            for h, hb in handlers:
                hctx = ctx.replace(in_except=True)
                htail = self._build_body(h.body, hb.bid, hctx)
                if htail is not None:
                    exits.append(htail)
            if stmt.finalbody:
                fin = self._spawn(ctx, in_finally=True)
                for e in exits:
                    self._edge(e, fin.bid)
                if not exits:
                    # every path raised/returned: the finally still
                    # runs on the way out
                    self._edge(cur, fin.bid)
                fctx = ctx.replace(in_finally=True)
                ftail = self._build_body(stmt.finalbody, fin.bid, fctx)
                if ftail is not None:
                    self._edge(ftail, after.bid)
            else:
                for e in exits:
                    self._edge(e, after.bid)
                if not exits:
                    return None
            return after.bid
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._add_unit(cur, stmt, list(stmt.items))
            locks = set(ctx.with_locks)
            for item in stmt.items:
                name = looks_like_lock(item.context_expr)
                if name:
                    locks.add(name)
            wctx = ctx.replace(with_locks=frozenset(locks))
            body_b = self._spawn(wctx)
            self._edge(cur, body_b.bid)
            tail = self._build_body(stmt.body, body_b.bid, wctx)
            if tail is None:
                return None
            after = self._spawn(ctx)
            self._edge(tail, after.bid)
            return after.bid
        # -- simple / opaque statements --------------------------------
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # nested defs are their own CFGs; index only the header
            self._add_unit(cur, stmt, [ast.Expr(value=d)
                                       for d in stmt.decorator_list]
                           or [ast.Pass()])
            return cur
        self._add_unit(cur, stmt)
        if isinstance(stmt, (ast.Return, ast.Raise)):
            self._edge(cur, self.exit)
            return None
        if isinstance(stmt, ast.Break):
            if ctx.loop_exit is not None:
                self._edge(cur, ctx.loop_exit)
            return None
        if isinstance(stmt, ast.Continue):
            if ctx.loop_header is not None:
                self._edge(cur, ctx.loop_header)
            return None
        return cur

    def _has_preds(self, bid: int) -> bool:
        return any(s == bid for b in self._blocks
                   for (s, _) in b.succs)

    # -- dataflow ------------------------------------------------------
    def _solve_guards(self) -> List[Optional[FrozenSet]]:
        """in[b] = ∩ over incoming edges of (out[pred] ∪ edge pin);
        out == in (statements never add pins). Meet over the CFG, so
        pins shrink to what holds on *every* path."""
        n = len(self._blocks)
        state: List[Optional[FrozenSet]] = [None] * n
        state[self.entry] = frozenset()
        preds: Dict[int, List[Tuple[int, Optional[Tuple[int, bool]]]]] \
            = {i: [] for i in range(n)}
        for b in self._blocks:
            for (succ, pin) in b.succs:
                preds[succ].append((b.bid, pin))
        for _ in range(n + 2):  # pins only shrink: converges fast
            changed = False
            for bid in range(n):
                if bid == self.entry:
                    continue
                contribs = []
                for (p, pin) in preds[bid]:
                    if state[p] is None:
                        continue
                    s = state[p]
                    if pin is not None:
                        s = s | {pin}
                    contribs.append(s)
                if not contribs:
                    continue
                new = frozenset.intersection(*contribs)
                if state[bid] is None or new != state[bid]:
                    state[bid] = new
                    changed = True
            if not changed:
                break
        return state

    def _solve_locks(self) -> List[Optional[FrozenSet[str]]]:
        """Forward ``.acquire()``/``.release()`` dataflow (meet = ∩).
        Lexical ``with lock:`` scopes are carried on the blocks
        themselves and unioned in at query time."""
        n = len(self._blocks)
        state: List[Optional[FrozenSet[str]]] = [None] * n
        state[self.entry] = frozenset()
        preds: Dict[int, List[int]] = {i: [] for i in range(n)}
        for b in self._blocks:
            for (succ, _) in b.succs:
                preds[succ].append(b.bid)
        outs: List[Optional[FrozenSet[str]]] = [None] * n
        for _ in range(2 * n + 2):
            changed = False
            for bid in range(n):
                known = [outs[p] for p in preds[bid]
                         if outs[p] is not None]
                if bid == self.entry:
                    inset: FrozenSet[str] = frozenset()
                elif known:
                    inset = frozenset.intersection(*known)
                else:
                    continue
                out = self._transfer_locks(bid, inset)
                if state[bid] != inset or outs[bid] != out:
                    state[bid] = inset
                    outs[bid] = out
                    changed = True
            if not changed:
                break
        return state

    def _transfer_locks(self, bid: int,
                        held: FrozenSet[str]) -> FrozenSet[str]:
        cur = held
        for uid in self._blocks[bid].units:
            cur = self._transfer_locks_one(uid, cur)
        return cur

    @staticmethod
    def _unit_expr_roots(stmt: ast.stmt) -> List[ast.AST]:
        """The expressions a unit itself evaluates. For compound
        statements that is the HEADER only — body statements live in
        their own blocks, and walking the whole subtree would
        attribute a branch-internal acquire()/release() to the header
        block and leak it down paths that never execute it."""
        if isinstance(stmt, (ast.If, ast.While)):
            return [stmt.test]
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return [stmt.target, stmt.iter]
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return list(stmt.items)
        if isinstance(stmt, (ast.Try, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            return []
        return [stmt]

    def _transfer_locks_one(self, uid: int,
                            held: FrozenSet[str]) -> FrozenSet[str]:
        cur = set(held)
        stmt, _ = self._units[uid]
        for root in self._unit_expr_roots(stmt):
            for sub in ast.walk(root):
                if not isinstance(sub, ast.Call) or \
                        not isinstance(sub.func, ast.Attribute):
                    continue
                name = looks_like_lock(sub.func.value)
                if name is None:
                    continue
                if sub.func.attr == "acquire":
                    cur.add(name)
                elif sub.func.attr == "release":
                    cur.discard(name)
        return frozenset(cur)

    # -- queries -------------------------------------------------------
    def info(self, node: ast.AST) -> Optional[UnitInfo]:
        """Flow facts for the statement containing ``node`` (any
        expression node inside it). None for nodes this CFG does not
        own (e.g. bodies of nested defs)."""
        uid = self._node_unit.get(id(node))
        if uid is None:
            return None
        stmt, bid = self._units[uid]
        block = self._blocks[bid]
        pins_raw = self._guards_in[bid]
        pins: List[Pin] = []
        if pins_raw:
            for (nid, pol) in sorted(pins_raw,
                                     key=lambda p: (self._pin_lineno(p),
                                                    p[1])):
                pins.append((self._pin_nodes[nid], pol))
        locks = self._unit_locks.get(uid, frozenset()) \
            | block.with_locks
        return UnitInfo(stmt=stmt, pins=pins,
                        in_except=block.in_except,
                        in_finally=block.in_finally,
                        held_locks=locks,
                        reachable=self._guards_in[bid] is not None)

    def _pin_lineno(self, pin) -> int:
        node = self._pin_nodes.get(pin[0])
        return getattr(node, "lineno", 0)

    def held_locks(self, node: ast.AST) -> FrozenSet[str]:
        got = self.info(node)
        return got.held_locks if got is not None else frozenset()


@dataclass(frozen=True)
class _Ctx:
    loop_header: Optional[int]
    loop_exit: Optional[int]
    in_except: bool
    in_finally: bool
    with_locks: FrozenSet[str]

    def replace(self, **kw) -> "_Ctx":
        data = dict(loop_header=self.loop_header,
                    loop_exit=self.loop_exit,
                    in_except=self.in_except,
                    in_finally=self.in_finally,
                    with_locks=self.with_locks)
        data.update(kw)
        return _Ctx(**data)

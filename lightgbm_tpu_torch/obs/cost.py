"""Cost attribution: the port's counterpart of
``lightgbm_tpu/obs/cost.py``.

Every entry point registered through
:func:`~lightgbm_tpu_torch.obs.jit_tracker.register_jit` is wrapped in a
:class:`CostTracked` proxy. The port has no XLA compile to notice, so a
*new call signature* takes its place: each entry declares how its
signature is read off a call (``signature=``; by default the tensors'
dtypes and shapes and the scalars' values, as a JAX signature is the
call's avals). At the first call of a new signature the proxy captures:

- ``flops`` / ``bytes_accessed``, from one of three sources in place of
  XLA's cost model:

  - **the two kernels** (``ops/pallas_hist``, K1; ``ops/partition``, K2):
    an analytic model of the launch's shapes, :func:`k1_work` and
    :func:`k2_work`, the same one ``chip_smoke.py``'s kernels line
    bounds them by;
  - **entries that are sequences of torch ops** (the serving walk,
    lambdarank, the trees' binned values): the input and output bytes of
    every aten op, counted by a ``TorchDispatchMode`` during that first
    call, and the flops ``torch.utils.flop_counter.FlopCounterMode``
    counts, read from its table in the same mode (``None`` where it
    counts nothing);
  - **a tree** (``ops/grow_tree``, ``parallel/dp_grow``): the sum over
    its first tree of the kernels' modelled costs and the counted torch
    ops. The kernels launch through ``ctypes`` (``ops/_cuda.py``), so the
    dispatch mode never sees them and nothing is counted twice;

- ``wall_ms`` — the first call's host wall, which takes in any ``nvcc``
  build and one device synchronize, once per signature, as the JAX
  package's takes in the compile;
- the device peaks (:func:`device_peaks`) and ``optimal_ms``, the larger
  of the compute time and the memory time at those peaks.

K1's and K2's windows change on every split, so their signatures are
their launch plans without the row count; a tree's signature is ``(n,
F, B, num_leaves, payload dtype)``.

Each capture emits one ``{"event": "compile"}`` record, key for key the
JAX package's, drained into the telemetry stream by the recorder and the
serving daemon and summarized by ``python -m lightgbm_tpu_torch stats``,
and feeds the registry families ``xla_compiles{entry=}`` (signatures,
not ``nvcc`` builds: those stay in ``jit_tracker.jit_cache_sizes``),
``xla_compile_ms``, ``xla_flops`` and ``xla_bytes_accessed``. At most
1024 records wait for a drain.

``LIGHTGBM_TPU_COST_ATTRIBUTION=0`` turns the capture off (read at every
call, so it holds for modules imported before it was set).
``LIGHTGBM_TPU_COST_OPTIMIZED`` asks the JAX package for a second,
post-optimization compile; the port compiles nothing per call, so it is
read and changes nothing. The JAX entries ``gbdt/fused_iter`` and
``gbdt/fused_scan`` have no counterpart: the port has no fused step
(``fused_scan_iters`` is a TPU knob it refuses).

Attribution never changes a result: the dispatch mode and the flop
counter call every op as it came, and the one read-back of a capture
(the windows' left counts) happens after the call.

Threading contract (the port's lint, TPL008 over ``obs/``): the pending
events and every entry's seen signatures are touched only under
``_events_lock`` / ``_sig_lock``; no torch work runs under either lock
(TPL006). This module imports no torch until a capture runs.
"""

from __future__ import annotations

import os
import threading
import time
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

from .registry import registry as _global_registry

__all__ = ["CostTracked", "drain_compile_events",
           "compile_events_snapshot", "device_peaks",
           "roofline_optimal_ms", "cost_wrap_enabled",
           "DEVICE_PEAKS", "H100_HBM_BYTES_PER_S", "H100_FP32_OPS_PER_S",
           "H100_INT32_OPS_PER_S", "k1_work", "k2_work", "k1_bound",
           "k2_bound", "signature_counts", "clear_signatures"]

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W): the rates
# K1's and K2's bounds use
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12
# scalar int32 adds: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the
# data sheet lists no scalar int32 rate; FP32's 67e12 counts an FMA as
# two operations on 128 lanes)
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9

#: peak compute (FP32 operations/s, without tensor cores) and HBM
#: bandwidth (bytes/s) per part, keyed by lower-case substrings of
#: ``torch.cuda.get_device_name``, the most specific first (NVIDIA's data
#: sheets). These are the rates K1's and K2's bounds use: neither kernel
#: runs on tensor cores, so the JAX table's bf16 systolic peaks would put
#: every bound 15x too low. Override with LIGHTGBM_TPU_PEAK_TFLOPS /
#: LIGHTGBM_TPU_PEAK_GBPS for parts not tabulated here.
DEVICE_PEAKS: Tuple[Tuple[str, float, float], ...] = (
    ("h100 nvl", 60e12, 3.9e12),
    ("h100 pcie", 51e12, 2.0e12),
    ("h100", H100_FP32_OPS_PER_S, H100_HBM_BYTES_PER_S),  # SXM, 80GB HBM3
)

#: pending {"event": "compile"} records awaiting a drain; bounded so a
#: process nobody scrapes never grows without limit
_EVENTS_CAP = 1024
_events_lock = threading.Lock()
_events: List[Dict[str, Any]] = []

# every live CostTracked's seen signatures, guarded by _sig_lock
_sig_lock = threading.Lock()
_trackers: "List[CostTracked]" = []

# per thread: the work-item lists of the captures running on it (a
# tree's capture collects its kernels' calls)
_local = threading.local()


def cost_wrap_enabled() -> bool:
    """LIGHTGBM_TPU_COST_ATTRIBUTION=0 is the kill switch: the wrapped
    entry points call straight through (no signature bookkeeping, no
    compile events)."""
    return os.environ.get("LIGHTGBM_TPU_COST_ATTRIBUTION",
                          "1") not in ("0", "off", "false")


def _optimized_requested() -> bool:
    """LIGHTGBM_TPU_COST_OPTIMIZED: read for the JAX package's contract;
    the port has no second compile to pay for, so it changes nothing."""
    return os.environ.get("LIGHTGBM_TPU_COST_OPTIMIZED", "") \
        not in ("", "0")


# -- device peaks ------------------------------------------------------

_peaks_lock = threading.Lock()
_peaks: Optional[Tuple[Optional[str], Optional[float],
                       Optional[float]]] = None


def _resolve_peaks() -> Tuple[Optional[str], Optional[float],
                              Optional[float]]:
    kind: Optional[str] = None
    try:
        import torch
        kind = torch.cuda.get_device_name(0) \
            if torch.cuda.is_available() else "cpu"
    except Exception:
        pass
    flops = bw = None
    if kind:
        low = kind.lower()
        for sub, f, b in DEVICE_PEAKS:
            if sub in low:
                flops, bw = f, b
                break
    env_f = os.environ.get("LIGHTGBM_TPU_PEAK_TFLOPS")
    env_b = os.environ.get("LIGHTGBM_TPU_PEAK_GBPS")
    try:
        if env_f:
            flops = float(env_f) * 1e12
        if env_b:
            bw = float(env_b) * 1e9
    except ValueError:
        pass
    return kind, flops, bw


def device_peaks() -> Tuple[Optional[str], Optional[float],
                            Optional[float]]:
    """(device name, peak FP32 operations/s, peak bytes/s) of the first
    CUDA device; Nones where unknown (the CPU has no tabulated peaks, so
    the roofline column reads n/a there)."""
    global _peaks
    with _peaks_lock:
        if _peaks is not None:
            return _peaks
    resolved = _resolve_peaks()        # may import torch: outside lock
    with _peaks_lock:
        if _peaks is None:
            _peaks = resolved
        return _peaks


def roofline_optimal_ms(flops: Optional[float],
                        bytes_accessed: Optional[float],
                        peak_flops: Optional[float],
                        peak_bytes_per_sec: Optional[float]) \
        -> Optional[float]:
    """Optimal runtime in ms at the device peaks: the larger of the
    compute time and the memory time. None when either side of the
    division is unknown."""
    candidates = []
    if flops is not None and peak_flops:
        candidates.append(flops / peak_flops)
    if bytes_accessed is not None and peak_bytes_per_sec:
        candidates.append(bytes_accessed / peak_bytes_per_sec)
    if not candidates:
        return None
    return max(candidates) * 1e3


# -- the kernels' model --------------------------------------------------

def k1_work(S: int, F: int, bin_bytes: int, pay_bytes: int,
            B: int) -> Tuple[int, int]:
    """K1's (operations, bytes) on ``S`` rows: each input read once
    (``S x F`` bins, ``S`` payload rows), the ``[F, B, 2]`` 4-byte output
    written once; one add per (row, feature, channel)."""
    return S * F * 2, S * F * bin_bytes + S * pay_bytes + F * B * 2 * 4


def k2_work(S: int, F: int, bin_bytes: int,
            pay_bytes: int) -> Tuple[int, int]:
    """K2's (operations, bytes) on a window of ``S`` rows: the rows
    (bins, payload, a 4-byte id) read once and written once."""
    return 0, 2 * S * (F * bin_bytes + pay_bytes + 4)


def k1_bound(S: int, F: int, bin_bytes: int, pay_bytes: int, B: int,
             ops_per_s: float,
             bytes_per_s: float = H100_HBM_BYTES_PER_S) -> Tuple[float, str]:
    """K1's (bound_ms, bound_by) at the given rates."""
    ops, nbytes = k1_work(S, F, bin_bytes, pay_bytes, B)
    bytes_s, ops_s = nbytes / bytes_per_s, ops / ops_per_s
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                       else "operations")


def k2_bound(S: int, F: int, bin_bytes: int, pay_bytes: int,
             bytes_per_s: float = H100_HBM_BYTES_PER_S) -> float:
    """K2's bound_ms: its bytes at the memory rate."""
    return 1e3 * k2_work(S, F, bin_bytes, pay_bytes)[1] / bytes_per_s


def _int_rate(peak_flops: Optional[float]) -> Optional[float]:
    """The scalar int32 add rate of a part, scaled from the H100's by
    its FP32 peak."""
    if not peak_flops:
        return None
    return H100_INT32_OPS_PER_S * peak_flops / H100_FP32_OPS_PER_S


def _resolve_work(items: List[tuple]) -> Tuple[int, int, int]:
    """(float-path operations, int-path operations, bytes) of kernel
    work items: ``("k1", F, bin_bytes, pay_bytes, B, int_path, start,
    cnt, side, n_left)`` or ``("k2", F, bin_bytes, pay_bytes, cnt)``.
    The left counts of side windows are device tensors, read back here
    in one copy."""
    nls = [it[9] for it in items if it[0] == "k1" and it[8]]
    host = []
    if nls:
        import torch
        host = torch.stack([t.reshape(()).to(torch.int64)
                            for t in nls]).cpu().tolist()
    ops_f = ops_i = nbytes = 0
    j = 0
    for it in items:
        if it[0] == "k1":
            _, F, bb, pb, B, int_path, _start, cnt, side, _nl = it
            S = cnt
            if side:
                nl = int(host[j])
                j += 1
                S = nl if side == 1 else cnt - nl
            o, b = k1_work(S, F, bb, pb, B)
            if int_path:
                ops_i += o
            else:
                ops_f += o
            nbytes += b
        else:
            _, F, bb, pb, cnt = it
            nbytes += k2_work(cnt, F, bb, pb)[1]
    return ops_f, ops_i, nbytes


def _optimal_ms(ops_f: float, ops_i: float, nbytes: Optional[float],
                peak_flops: Optional[float],
                peak_bw: Optional[float]) -> Optional[float]:
    """The roofline of mixed work: float operations at the FP32 peak and
    int32 adds at the int rate, against the bytes at the memory rate
    (:func:`roofline_optimal_ms` when there are no int adds)."""
    if not ops_i:
        return roofline_optimal_ms(ops_f, nbytes, peak_flops, peak_bw)
    rate = _int_rate(peak_flops)
    candidates = []
    if peak_flops and rate:
        candidates.append(ops_f / peak_flops + ops_i / rate)
    if nbytes is not None and peak_bw:
        candidates.append(nbytes / peak_bw)
    return max(candidates) * 1e3 if candidates else None


# -- signature description --------------------------------------------

def _describe_leaf(x: Any) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        name = str(dtype).replace("torch.", "")
        return f"{name}[{','.join(str(d) for d in shape)}]"
    if isinstance(x, (bool, int, float, str)) or x is None:
        return repr(x)[:32]
    return type(x).__name__


def _describe_args(args: tuple, kwargs: dict) -> str:
    """Short human signature of a call: dtypes and shapes of the
    tensors plus the scalars, capped — diagnostic text, never parsed."""
    leaves = list(args) + list(kwargs.values())
    parts = [_describe_leaf(leaf) for leaf in leaves[:24]]
    if len(leaves) > 24:
        parts.append(f"+{len(leaves) - 24} more")
    return ",".join(parts)


def _default_signature(args: tuple, kwargs: dict) -> tuple:
    """The call's avals: dtype, shape and device of every tensor or
    array argument, the value of every scalar, the type of anything
    else."""
    out = []
    for x in list(args) + [kwargs[k] for k in sorted(kwargs)]:
        shape = getattr(x, "shape", None)
        if shape is not None and getattr(x, "dtype", None) is not None:
            out.append((str(x.dtype), tuple(shape),
                        str(getattr(x, "device", "host"))))
        elif isinstance(x, (bool, int, float, str)) or x is None:
            out.append(x)
        else:
            out.append(type(x).__name__)
    return tuple(sorted(kwargs)), tuple(out)


# -- the capture -------------------------------------------------------

def _device_of(objs) -> Optional[Any]:
    for x in objs:
        dev = getattr(x, "device", None)
        if dev is not None and getattr(dev, "type", None) == "cuda":
            return dev
    return None


def _sync(args: tuple, out: Any) -> None:
    dev = _device_of(list(args) + [out])
    if dev is None:
        return
    import torch
    torch.cuda.synchronize(dev)


def _counting_mode():
    """The dispatch mode of one capture: bytes and flops of the aten ops
    dispatched under it."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    import torch
    Tensor = torch.Tensor

    def nbytes(x) -> int:
        # an aten op's arguments and results: tensors, and lists or
        # tuples of them (no deeper nesting)
        if isinstance(x, Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, (list, tuple)):
            return sum(t.numel() * t.element_size() for t in x
                       if isinstance(t, Tensor))
        return 0

    class _Counter(TorchDispatchMode):
        """Input and output bytes of every aten op dispatched under it
        that moves data (a view — a slice, a select, a reshape — and an
        allocation move none, and would count a whole buffer for a
        window of it), and the flops of the ops
        ``torch.utils.flop_counter.FlopCounterMode`` counts, from that
        counter's own table (the mode itself tracks modules per op, which
        costs ~100 us an op: minutes on a 255-leaf tree). Each op runs as
        it came."""

        def __init__(self):
            super().__init__()
            self.nbytes = 0
            self.flops = 0
            self.counted = False   # did the flop table know any op?

    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = rules.get(func)
        if rule is None:
            rule = rules[func] = (
                not func.is_view and func not in no_bytes,
                flop_registry.get(func._overloadpacket))
        moves, count = rule
        if moves:
            self.nbytes += nbytes(out) + sum(nbytes(a) for a in args)
            if kwargs:
                self.nbytes += sum(nbytes(v) for v in kwargs.values())
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
            self.counted = True
        return out

    # set after the class body on purpose: TorchDispatchMode wraps a
    # ``__torch_dispatch__`` defined in the body in torch.compile's guard,
    # ~25 us an aten op (most of a 255-leaf tree's capture) and, in a
    # fresh process, the import of the compiler; the port compiles
    # nothing
    _Counter.__torch_dispatch__ = dispatch
    aten = torch.ops.aten
    no_bytes = {aten.empty.memory_format, aten.empty_strided.default,
                aten.empty_like.default}
    rules: Dict[Any, tuple] = {}   # op -> (moves data, flop counter)
    return _Counter()


def _collectors() -> List[list]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _enqueue(name: str, signature: str, flops: Optional[float],
             nbytes: Optional[float], wall_ms: float,
             optimal: Optional[float], kind, peak_flops, peak_bw) -> None:
    event = {
        "event": "compile",
        "entry": name,
        "signature": signature,
        "flops": flops,
        "bytes_accessed": nbytes,
        "wall_ms": round(wall_ms, 3),
        "compiles": 1,
        "device_kind": kind,
        "peak_flops": peak_flops,
        "peak_bytes_per_sec": peak_bw,
        "optimal_ms": optimal,
        "time": time.time(),
    }
    with _events_lock:
        _events.append(event)
        if len(_events) > _EVENTS_CAP:
            del _events[:len(_events) - _EVENTS_CAP]
    reg = _global_registry
    reg.counter("xla_compiles", entry=name).inc(1)
    reg.histogram("xla_compile_ms", entry=name).observe(wall_ms)
    if flops is not None:
        reg.gauge("xla_flops", entry=name).set(flops)
    if nbytes is not None:
        reg.gauge("xla_bytes_accessed", entry=name).set(nbytes)


def drain_compile_events() -> List[Dict[str, Any]]:
    """Locked snapshot-and-clear of the pending compile records (the
    ``faults.drain_events`` contract: a concurrent append can never be
    lost between a copy and a clear)."""
    global _events
    with _events_lock:
        drained, _events = _events, []
    return drained


def compile_events_snapshot() -> List[Dict[str, Any]]:
    """Non-destructive copy of the pending records (tests, the smoke)."""
    with _events_lock:
        return list(_events)


def signature_counts() -> Dict[str, int]:
    """Distinct call signatures seen per entry name since the process
    started (or the last :func:`clear_signatures`)."""
    out: Dict[str, int] = {}
    with _sig_lock:
        for t in _trackers:
            out[t._name] = out.get(t._name, 0) + len(t._seen)
    return out


def clear_signatures() -> None:
    """Forget every entry's seen signatures (the counterpart of
    ``jax.clear_caches``): the next call of each signature is captured
    anew."""
    with _sig_lock:
        for t in _trackers:
            t._seen.clear()


class CostTracked:
    """Call-through proxy over one entry point.

    ``signature(args, kwargs)`` gives the call's hashable signature;
    ``work(args, kwargs, out)``, for a kernel entry, the work item its
    analytic model costs (:func:`_resolve_work`). Attribute reads and
    writes go through to the wrapped function (its launch counters), and
    on a class the proxy binds like a method."""

    __slots__ = ("_fn", "_name", "_signature", "_work", "_seen",
                 "__weakref__")

    def __init__(self, name: str, fn: Callable,
                 signature: Optional[Callable] = None,
                 work: Optional[Callable] = None):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_signature",
                           signature or _default_signature)
        object.__setattr__(self, "_work", work)
        object.__setattr__(self, "_seen", set())
        with _sig_lock:
            _trackers.append(self)

    @property
    def unwrapped(self) -> Callable:
        return self._fn

    @property
    def entry_name(self) -> str:
        return self._name

    def signature_count(self) -> int:
        with _sig_lock:
            return len(self._seen)

    def __call__(self, *args, **kwargs):
        fn = self._fn
        if not cost_wrap_enabled():
            return fn(*args, **kwargs)
        stack = _collectors()
        key = self._signature(args, kwargs)
        with _sig_lock:
            new = key not in self._seen
            if new:
                self._seen.add(key)
        if self._work is not None:
            if not new and not stack:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            if stack:
                # a tree's capture: the model costs the kernel, so the
                # counting mode must not also see its plain version's
                # ops (the CPU's; a CUDA launch is invisible to them)
                from torch.utils._python_dispatch import \
                    _disable_current_modes
                with _disable_current_modes():
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            item = self._work(args, kwargs, out)
            for items in stack:
                items.append(item)
            if new:
                _sync(args, out)
                wall_ms = (time.perf_counter() - t0) * 1e3
                self._capture(args, kwargs, wall_ms, [item], 0, None)
            return out
        if not new:
            return fn(*args, **kwargs)
        counter = _counting_mode()
        items: list = []
        stack.append(items)
        t0 = time.perf_counter()
        try:
            with counter:
                out = fn(*args, **kwargs)
            _sync(args, out)
        finally:
            stack.remove(items)
        wall_ms = (time.perf_counter() - t0) * 1e3
        self._capture(args, kwargs, wall_ms, items, counter.nbytes,
                      counter.flops if counter.counted else None)
        return out

    def _capture(self, args, kwargs, wall_ms: float, items: list,
                 op_bytes: int, op_flops) -> None:
        """Build and enqueue one compile record: the kernels' modelled
        work plus the counted torch ops."""
        ops_f, ops_i, k_bytes = _resolve_work(items)
        # the JAX package's second compile: nothing to pay for here
        _optimized_requested()
        ops_f += int(op_flops or 0)
        flops = float(ops_f + ops_i) if (ops_f or ops_i) else None
        nbytes = float(k_bytes + op_bytes)
        kind, peak_flops, peak_bw = device_peaks()
        optimal = _optimal_ms(ops_f, ops_i, nbytes, peak_flops, peak_bw)
        _enqueue(self._name, _describe_args(args, kwargs), flops, nbytes,
                 wall_ms, optimal, kind, peak_flops, peak_bw)

    def __get__(self, obj, objtype=None):
        return self if obj is None else types.MethodType(self, obj)

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "_fn"), item)

    def __setattr__(self, item, value):
        setattr(self._fn, item, value)

    def __repr__(self) -> str:
        return f"CostTracked({self._name!r}, {self._fn!r})"

"""Forest compiler: one trained Booster -> a servable compiled forest.

Counterpart of ``lightgbm_tpu/serve/compile.py``. ``Booster.predict``
stacks the trees into device tensors on every call
(``prediction.py`` ``stack_trees``); here the forest is stacked ONCE
(``ops/predict.py`` ``StackedTrees``: node arrays, categorical bitsets,
linear-leaf coefficients) and a batch walks it with the same torch ops
as ``Booster.predict`` (``prediction.py`` ``forest_scores``), so the
two answer bit for bit alike.

Each compiled forest carries a ``model_id``: the JAX package's digest
of the stacked fields, so the same model file has the same id in both
packages.

Two serving invariants live here:

- **Shape bucketing**: rows are padded up to power-of-two buckets
  between ``min_bucket`` and ``max_batch_rows`` and sliced back on the
  host, so the device walk only ever sees ``log2(max/min) + 1`` row
  counts per model, all touched by :meth:`CompiledForest.warmup`. The
  JAX package counts its recompiles; the port counts the distinct
  padded shapes that reached the device walk (:func:`padded_shapes`),
  which stays flat after warmup for any batch size.
- **In-place hot swap**: a model swap stages the NEW forest on the host
  and, when its layout matches the old one's field for field (shape and
  dtype), writes each field into the old forest's device tensor
  (``Tensor.copy_``), so no second resident forest ever exists; the old
  forest is then dead and raises. When layouts differ, the whole new
  forest is uploaded.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np
import torch

from ..obs import jit_tracker
from ..ops.predict import StackedTrees
from ..prediction import convert_raw_scores, forest_scores, stack_trees

__all__ = ["CompiledForest", "compile_forest", "bucket_rows",
           "n_serve_buckets", "padded_shapes"]

#: the ``obs/jit_tracker.py`` entry of the walk's padded shapes
_ENTRY = "serve/predict"


def padded_shapes() -> int:
    """How many distinct padded ``(rows, features, trees, K)`` shapes
    reached the device walk in this process (the port's counterpart of
    the JAX recompile counter; ``obs.RecompileWatcher`` counts them)."""
    return jit_tracker.shape_count(_ENTRY)


def bucket_rows(n: int, min_bucket: int = 16,
                max_bucket: int = 16384) -> int:
    """Smallest power-of-two >= ``n`` clamped to [min_bucket,
    max_bucket]. Requests larger than ``max_bucket`` are split by the
    caller; everything else pads up."""
    if n <= 0:
        raise ValueError(f"batch must have at least one row, got {n}")
    b = 1 << (int(n) - 1).bit_length()
    return max(min_bucket, min(b, max_bucket))


def n_serve_buckets(min_bucket: int = 16,
                    max_bucket: int = 16384) -> int:
    """Number of distinct pow2 row buckets ``bucket_rows`` can emit."""
    import math

    return int(math.log2(max_bucket // min_bucket)) + 1


def _fields(stacked: StackedTrees):
    """``(name, tensor)`` of every tensor field of a stacked forest."""
    return [(k, v) for k, v in zip(stacked._fields, stacked)
            if isinstance(v, torch.Tensor)]


def _layouts_match(old: StackedTrees, new: StackedTrees) -> bool:
    a, b = _fields(old), _fields(new)
    return [k for k, _ in a] == [k for k, _ in b] and all(
        x.shape == y.shape and x.dtype == y.dtype
        for (_, x), (_, y) in zip(a, b))


def _model_digest(host: StackedTrees) -> str:
    """Short stable id of a stacked forest, for telemetry and the
    daemon's replies ("which model answered"): the JAX package's
    ``serve/compile.py`` ``_model_digest``, which hashes its own layout
    (``lightgbm_tpu/prediction.py`` ``stack_trees``). The port stacks
    other dtypes (int64 indices, no ``threshold_bin``, no categorical
    fields in a forest without categorical splits), so the JAX layout's
    prediction fields are rebuilt here in its order and dtypes; the same
    model text gets the same id in both packages."""
    T, N = host.split_feature.shape

    def arr(t, dtype):
        return np.ascontiguousarray(t.numpy().astype(dtype, copy=False))

    ic = np.zeros((T, N), bool) if host.is_categorical is None \
        else arr(host.is_categorical, bool)
    bits = np.zeros((T, N, 1), np.uint32) if host.cat_bitset is None \
        else arr(host.cat_bitset, np.uint32)
    fields = [arr(host.split_feature, np.int32),
              arr(host.threshold, np.float32),
              arr(host.default_left, bool), arr(host.missing_type, np.int8),
              ic, bits, arr(host.left_child, np.int32),
              arr(host.right_child, np.int32),
              arr(host.leaf_value, np.float32)]
    if host.lin_const is not None:
        fields += [arr(host.lin_const, np.float32),
                   arr(host.lin_nfeat, np.int32),
                   arr(host.lin_feats, np.int32),
                   arr(host.lin_coef, np.float32)]
    h = hashlib.sha256()
    for f in fields:
        h.update(f.tobytes())
    return h.hexdigest()[:16]


def _upload(host: StackedTrees, device) -> StackedTrees:
    return host._replace(**{k: v.to(device) for k, v in _fields(host)})


class CompiledForest:
    """A forest stacked on the device plus its serving metadata.

    Build via :func:`compile_forest` (or ``Booster.compile()``, which
    also routes later ``Booster.predict`` calls through it)."""

    def __init__(self, stacked, *, num_class: int, n_features: int,
                 objective_str: str, avg_output: bool,
                 num_iteration: int, lo: int, hi: int,
                 total_trees: int, device, model_id: str = "empty",
                 min_bucket: int = 16, max_batch_rows: int = 16384):
        self._stacked = stacked           # device StackedTrees (or None)
        self._host = None                 # staged host arrays (stage=True)
        self._dead = False                # tensors taken by a successor
        self.device = torch.device(device)
        self.K = int(num_class)
        self.n_features = int(n_features)
        self.objective_str = objective_str
        self.avg_output = bool(avg_output)
        self.num_iteration = int(num_iteration)
        self.lo = int(lo)
        self.hi = int(hi)
        self.total_trees = int(total_trees)
        self.model_id = model_id
        if min_bucket < 1 or (min_bucket & (min_bucket - 1)) != 0:
            raise ValueError(f"min_bucket must be a power of two >= 1, "
                             f"got {min_bucket}")
        if max_batch_rows < min_bucket or \
                (max_batch_rows & (max_batch_rows - 1)) != 0:
            raise ValueError(
                "max_batch_rows must be a power of two >= min_bucket, "
                f"got {max_batch_rows}")
        self.min_bucket = int(min_bucket)
        self.max_batch_rows = int(max_batch_rows)

    @property
    def num_trees(self) -> int:
        return self.hi - self.lo

    def matches(self, lo: int, hi: int, total_trees: int) -> bool:
        """Does this compilation still describe the Booster state a
        predict call wants? A dead forest never matches, so a booster
        still caching it falls back to the eager path."""
        return not self._dead and \
            (self.lo, self.hi, self.total_trees) == (lo, hi, total_trees)

    def buckets(self) -> List[int]:
        out = []
        b = self.min_bucket
        while b <= self.max_batch_rows:
            out.append(b)
            b *= 2
        return out

    # -- prediction ----------------------------------------------------
    def _walk(self, chunk: np.ndarray) -> np.ndarray:  # tpulint: hot
        """``[b, K]`` float32 raw scores of one padded chunk."""
        st = self._stacked
        jit_tracker.note_shape(_ENTRY, (chunk.shape[0], chunk.shape[1],
                                        int(st.leaf_value.shape[0]),
                                        self.K))
        Xd = torch.from_numpy(chunk).to(self.device)
        return forest_scores(st, Xd, self.K).T.cpu().numpy()

    def predict_raw(self, X) -> np.ndarray:
        """Raw scores ``[n, K]`` (f64) for raw-feature rows ``[n, F]``.

        Rows are padded to the enclosing power-of-two bucket (chunked
        at ``max_batch_rows``) and the padded result is sliced on the
        host, so after warmup no batch size brings a new shape to the
        device."""
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        if X.ndim == 1:
            X = X[None, :]
        if X.shape[1] != self.n_features:
            from ..basic import LightGBMError
            raise LightGBMError(
                f"The number of features in data ({X.shape[1]}) is not "
                f"the same as it was in training data "
                f"({self.n_features}).")
        n = X.shape[0]
        if self._dead:
            raise RuntimeError(
                "this forest's device tensors were donated to a newer "
                "compilation (compile_forest(reuse=...)); it must not "
                "predict again")
        if n == 0:
            return np.zeros((0, self.K), np.float64)
        if self._stacked is None:
            if self._host is not None:
                raise RuntimeError(
                    "forest is staged on the host: call attach() "
                    "before predicting")
            return np.zeros((n, self.K), np.float64)  # empty forest
        outs = []
        for lo in range(0, n, self.max_batch_rows):
            chunk = X[lo:lo + self.max_batch_rows]
            rows = chunk.shape[0]
            b = bucket_rows(rows, self.min_bucket, self.max_batch_rows)
            if b > rows:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - rows, X.shape[1]),
                                     np.float32)])
            outs.append(self._walk(chunk)[:rows].astype(np.float64))
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def finalize(self, raw_scores: np.ndarray,
                 raw_score: bool = False) -> np.ndarray:
        """Objective transform + rf averaging + K==1 squeeze: the tail
        of ``Booster.predict``, on the host."""
        out = raw_scores
        if self.avg_output:
            out = out / max(1, self.num_iteration)
        if not raw_score:
            out = convert_raw_scores(self.objective_str, out)
        return out[:, 0] if self.K == 1 else out

    def predict(self, X, raw_score: bool = False) -> np.ndarray:
        return self.finalize(self.predict_raw(X), raw_score)

    # -- lifecycle -----------------------------------------------------
    def warmup(self, max_rows: Optional[int] = None) -> int:
        """Walk a zero batch of every row bucket up to ``max_rows``
        (default: all of them); returns the number of buckets touched.
        After this, no batch of at most ``max_rows`` rows brings a new
        shape to the device."""
        if self._stacked is None:
            return 0
        cap = self.max_batch_rows if max_rows is None \
            else max(self.min_bucket, int(max_rows))
        touched = 0
        for b in self.buckets():
            if b > cap:
                break
            self._walk(np.zeros((b, self.n_features), np.float32))
            touched += 1
        return touched

    def attach(self, reuse: Optional["CompiledForest"] = None) \
            -> "CompiledForest":
        """Upload this forest's STAGED host arrays
        (``compile_forest(..., stage=True)``), writing them into
        ``reuse``'s device tensors when the layouts match. Run it where
        no batch can still be walking ``reuse`` (the batcher's worker,
        through ``MicroBatcher.swap_deferred``)."""
        if self._host is None:
            return self
        host, self._host = self._host, None
        if reuse is not None:
            reuse.adopt(host)
            self._stacked, reuse._stacked = reuse._stacked, None
            reuse._dead = True
        else:
            self._stacked = _upload(host, self.device)
        return self

    def adopt(self, host_stacked: Optional[StackedTrees]):
        """Replace the device forest with ``host_stacked`` (host
        tensors): field by field into the old device tensors when the
        layouts line up (the extra device memory is none), else a whole
        upload. Internal: used by :func:`compile_forest` via
        ``reuse=``."""
        if host_stacked is None:
            self._stacked = None
            return
        old = self._stacked
        if old is not None and _layouts_match(old, host_stacked):
            for (_, o), (_, h) in zip(_fields(old), _fields(host_stacked)):
                o.copy_(h)
            # the non-tensor fields (the walk's depth) come from the new
            # forest
            self._stacked = host_stacked._replace(**dict(_fields(old)))
        else:
            self._stacked = None     # drop the old forest first
            self._stacked = _upload(host_stacked, self.device)


def _walk_signature(args, kwargs) -> tuple:
    """The walk's cost signature: its padded ``(rows, features, trees,
    K)`` shape, the one ``jit_tracker.note_shape`` counts, and device."""
    forest, chunk = args[0], args[1]
    return (chunk.shape[0], chunk.shape[1],
            int(forest._stacked.leaf_value.shape[0]), forest.K,
            str(forest.device))


# the warmup's power-of-two buckets, each at most once per forest shape
CompiledForest._walk = jit_tracker.register_jit(
    _ENTRY, CompiledForest._walk, max_signatures=2 * n_serve_buckets(),
    signature=_walk_signature)


def compile_forest(booster, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   min_bucket: int = 16,
                   max_batch_rows: int = 16384,
                   reuse: Optional[CompiledForest] = None,
                   stage: bool = False) -> CompiledForest:
    """Stack ``booster``'s forest into a :class:`CompiledForest` on the
    booster's device.

    Tree selection matches ``Booster.predict`` (``start_iteration`` /
    ``num_iteration`` in boosting rounds; <=0 means all remaining).
    ``reuse``: a previous compilation whose device tensors the new
    model takes over (the hot swap); after this call the reused forest
    is dead and must not predict again. ``stage=True`` keeps the
    tensors on the HOST (no device memory touched); call
    :meth:`CompiledForest.attach` to upload later.
    """
    trees = booster._models
    K = booster.num_model_per_iteration()
    total_iters = len(trees) // max(K, 1)
    if num_iteration is None or num_iteration <= 0:
        num_iteration = total_iters - start_iteration
    num_iteration = max(0, min(num_iteration,
                               total_iters - start_iteration))
    lo = start_iteration * K
    hi = (start_iteration + num_iteration) * K
    sel = trees[lo:hi]
    device = booster._device
    host = stack_trees(sel, "cpu") if sel else None
    model_id = _model_digest(host) if host is not None else "empty"
    if stage:
        stacked = None
    elif reuse is not None:
        reuse.adopt(host)
        stacked = reuse._stacked
        reuse._stacked = None        # ownership moves to the new forest
        reuse._dead = True           # reuse must raise, not serve zeros
    elif host is not None:
        stacked = _upload(host, device)
    else:
        stacked = None
    cf = CompiledForest(
        stacked, num_class=K, n_features=booster.num_feature(),
        objective_str=booster._objective_str,
        avg_output=booster._avg_output,
        num_iteration=max(1, num_iteration), lo=lo, hi=hi,
        total_trees=len(trees), device=device, model_id=model_id,
        min_bucket=min_bucket, max_batch_rows=max_batch_rows)
    if stage:
        cf._host = host
    return cf

"""The port's in-process serving (lightgbm_tpu_torch/serve/: the
compiled forest and the micro-batcher) held against its own eager
predictions and the JAX package's ``CompiledForest`` on the CPU.

Mirrors tests/test_serve.py's forest-compiler and micro-batcher tests,
and tests/test_pipeline.py's shedding tests; the daemon's are in
tests/test_torch_daemon.py. The port's models train on the CPU; the JAX forest is
compiled from the same model text. Compiled predictions equal the
port's eager ones exactly (the same torch ops in the same order) and
the JAX ones to rtol 1e-6, atol 1e-6. The JAX recompile counter's
invariant becomes the port's count of distinct padded shapes that
reached the device walk: flat after warmup.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.serve.compile import compile_forest as jax_compile_forest
from lightgbm_tpu_torch.serve.batcher import (MicroBatcher, QueueFullError,
                                              SheddingError)
from lightgbm_tpu_torch.serve.compile import (bucket_rows, compile_forest,
                                              n_serve_buckets,
                                              padded_shapes)

CPU = {"device_type": "cpu", "verbosity": -1}
RS = np.random.RandomState(31)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Drop the JAX programs this module compiled when it ends (the
    process-wide jit signature budgets of later tests)."""
    yield
    jax.clear_caches()


def _synthetic(n, f, seed):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    y = ((X @ rs.randn(f) + 0.5 * rs.randn(n)) > 0).astype(np.float64)
    return X, y


def _train(params, X, y, rounds=5, **ds_kwargs):
    ds = tlgb.Dataset(X, label=y, params=CPU, **ds_kwargs)
    return tlgb.train({**CPU, **params}, ds, num_boost_round=rounds)


@pytest.fixture(scope="module")
def binary_model():
    X, y = _synthetic(600, 8, 3)
    return _train({"objective": "binary", "num_leaves": 15}, X, y), X


@pytest.fixture(scope="module")
def other_binary_model(binary_model):
    _, X = binary_model
    return _train({"objective": "binary", "num_leaves": 15}, X,
                  (X[:, 1] > 0).astype(np.float64))


@pytest.fixture(scope="module")
def multiclass_model():
    X, _ = _synthetic(500, 6, 5)
    y = (np.abs(X[:, 0]) + X[:, 1] > 0.6).astype(int) \
        + (X[:, 2] > 0.5).astype(int)
    return _train({"objective": "multiclass", "num_class": 3,
                   "num_leaves": 7}, X, y.astype(np.float64), rounds=4), X


@pytest.fixture(scope="module")
def categorical_model():
    n = 500
    Xn = RS.randn(n, 3)
    cat = RS.randint(0, 6, n).astype(np.float64)
    X = np.column_stack([Xn, cat])
    y = ((Xn[:, 0] > 0) ^ (cat >= 3)).astype(np.float64)
    return _train({"objective": "binary", "num_leaves": 15}, X, y,
                  categorical_feature=[3]), X


@pytest.fixture(scope="module")
def linear_model():
    X, _ = _synthetic(500, 5, 11)
    y = X @ RS.randn(5) + 0.05 * RS.randn(500)
    return _train({"objective": "regression", "num_leaves": 7,
                   "linear_tree": True}, X, y), X


def _fresh(bst):
    """An uncompiled clone: the eager path."""
    return tlgb.Booster(model_str=bst.model_to_string(), params=CPU)


# ---- the forest compiler ---------------------------------------------------

def test_bucket_ladder():
    assert bucket_rows(1) == 16
    assert bucket_rows(16) == 16
    assert bucket_rows(17) == 32
    assert bucket_rows(1000) == 1024
    assert bucket_rows(10 ** 9, max_bucket=4096) == 4096
    assert bucket_rows(5, min_bucket=1, max_bucket=8) == 8
    assert n_serve_buckets() == 11 == len(
        compile_forest(_fresh(_train({"objective": "binary"},
                                     *_synthetic(100, 2, 0), rounds=1)))
        .buckets())
    with pytest.raises(ValueError):
        bucket_rows(0)


MODELS = ["binary_model", "multiclass_model", "categorical_model",
          "linear_model"]


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("fixture", MODELS)
def test_compiled_equals_eager_and_jax(fixture, raw, request):
    """Exactly the eager path's answers at ad-hoc batch sizes (padded
    ones included), and the JAX CompiledForest's of the same model text
    to 1e-6."""
    bst, X = request.getfixturevalue(fixture)
    eager = _fresh(bst)
    cf = compile_forest(bst, max_batch_rows=256)
    jcf = jax_compile_forest(jlgb.Booster(model_str=bst.model_to_string()),
                             max_batch_rows=256)
    for n in (1, 7, 33, 123):
        got = cf.predict(X[:n], raw_score=raw)
        np.testing.assert_array_equal(got, eager.predict(X[:n],
                                                         raw_score=raw))
    np.testing.assert_allclose(got, jcf.predict(X[:123], raw_score=raw),
                               rtol=1e-6, atol=1e-6)


def test_booster_predict_routes_through_the_compiled_forest(binary_model):
    bst, X = binary_model
    want = _fresh(bst).predict(X[:300])
    cf = bst.compile(max_batch_rows=256)
    assert bst._compiled_forest is cf
    before = padded_shapes()
    # 300 rows: one 256-row chunk and a 64-row bucket
    np.testing.assert_array_equal(bst.predict(X[:300]), want)
    np.testing.assert_array_equal(bst.predict(X[:300]),
                                  cf.predict(X[:300]))
    assert padded_shapes() - before <= 2


def test_shape_count_flat_after_warmup(binary_model):
    """THE serving contract: after warmup, varied batch sizes bring no
    new padded shape to the device walk."""
    bst, X = binary_model
    cf = bst.compile(max_batch_rows=1024)
    assert cf.warmup() == len(cf.buckets())
    before = padded_shapes()
    for n in (1, 3, 17, 100, 255, 256, 257, 512, 700, 1000, 3000):
        Xq = RS.randn(n, X.shape[1])
        bst.predict(Xq)
        cf.predict_raw(Xq.astype(np.float32))
    assert padded_shapes() == before


def test_compiled_bypassed_when_the_booster_grows():
    X, y = _synthetic(400, 6, 9)
    bst = tlgb.train({"objective": "binary", "num_leaves": 7, **CPU},
                     tlgb.Dataset(X, label=y, params=CPU), 3)
    cf = bst.compile()
    before = bst.predict(X[:20])
    np.testing.assert_array_equal(before, _fresh(bst).predict(X[:20]))
    bst.update()
    assert bst.num_trees() == 4
    assert not cf.matches(0, bst.num_trees(), bst.num_trees())
    full = bst.predict(X[:20], num_iteration=4)
    np.testing.assert_array_equal(
        full, _fresh(bst).predict(X[:20], num_iteration=4))
    assert not np.allclose(full, before)


@pytest.mark.parametrize("change", ["rollback_update", "set_leaf_output"])
def test_changed_trees_drop_the_compiled_forest(change):
    """The port departs from the JAX package here: a change to the trees
    that keeps their count drops the compiled forest, so predict answers
    from the changed trees, never from the stale stack."""
    X, y = _synthetic(400, 6, 9)
    bst = tlgb.train({"objective": "binary", "num_leaves": 7, **CPU},
                     tlgb.Dataset(X, label=y, params=CPU), 3)
    bst.compile()
    before = bst.predict(X[:20])
    if change == "rollback_update":
        bst.rollback_one_iter()
        bst.update(fobj=lambda score, ds: (score - 2.0 * y,
                                           np.ones_like(score)))
    else:
        bst.set_leaf_output(0, 0, 5.0)
    assert bst.num_trees() == 3
    assert bst._compiled_forest is None
    after = bst.predict(X[:20])
    np.testing.assert_array_equal(after, _fresh(bst).predict(X[:20]))
    assert not np.allclose(after, before)


def test_compile_respects_num_iteration(binary_model):
    bst, X = binary_model
    want = _fresh(bst).predict(X[:40], num_iteration=2)
    np.testing.assert_array_equal(
        compile_forest(bst, num_iteration=2).predict(X[:40]), want)
    bst.compile(num_iteration=2)
    np.testing.assert_array_equal(bst.predict(X[:40], num_iteration=2),
                                  want)
    np.testing.assert_array_equal(bst.predict(X[:40]),
                                  _fresh(bst).predict(X[:40]))
    jcf = jax_compile_forest(jlgb.Booster(model_str=bst.model_to_string()),
                             num_iteration=2)
    np.testing.assert_allclose(want, jcf.predict(X[:40]), rtol=1e-6,
                               atol=1e-6)


def test_feature_count_mismatch_raises(binary_model):
    bst, X = binary_model
    with pytest.raises(tlgb.LightGBMError, match="number of features"):
        compile_forest(bst).predict_raw(np.zeros((4, X.shape[1] + 2)))


def test_zero_rows(binary_model):
    bst, X = binary_model
    cf = compile_forest(bst, max_batch_rows=256)
    assert cf.predict_raw(np.empty((0, X.shape[1]))).shape == (0, 1)
    bst.compile(max_batch_rows=256)
    assert bst.predict(np.empty((0, X.shape[1]))).shape == (0,)


def test_in_place_swap_keeps_the_tensors(binary_model, other_binary_model):
    """A same-layout swap writes the new model into the old forest's
    tensors (their data_ptr kept) and leaves the old forest dead; a
    different layout uploads a whole forest. Either way the new forest
    answers as its booster."""
    bst, X = binary_model
    cf_a = compile_forest(bst, max_batch_rows=256)
    ptrs = [t.data_ptr() for t in cf_a._stacked
            if isinstance(t, torch.Tensor)]
    a_pred = cf_a.predict(X[:30])
    cf_b = compile_forest(other_binary_model, max_batch_rows=256,
                          reuse=cf_a)
    assert cf_a._stacked is None and cf_a._dead
    assert [t.data_ptr() for t in cf_b._stacked
            if isinstance(t, torch.Tensor)] == ptrs
    np.testing.assert_array_equal(cf_b.predict(X[:30]),
                                  _fresh(other_binary_model).predict(X[:30]))
    assert not np.allclose(cf_b.predict(X[:30]), a_pred)
    with pytest.raises(RuntimeError, match="donated"):
        cf_a.predict_raw(X[:4])
    # a staged forest attached onto cf_b: the same in-place write
    cf_c = compile_forest(bst, max_batch_rows=256, stage=True)
    with pytest.raises(RuntimeError, match="attach"):
        cf_c.predict_raw(X[:4])
    cf_c.attach(reuse=cf_b)
    assert cf_b._dead and [t.data_ptr() for t in cf_c._stacked
                           if isinstance(t, torch.Tensor)] == ptrs
    np.testing.assert_array_equal(cf_c.predict(X[:30]), a_pred)
    # another layout (more leaves and trees): a plain upload
    big = _train({"objective": "binary", "num_leaves": 31}, X,
                 (X[:, 1] > 0).astype(np.float64), rounds=7)
    cf_d = compile_forest(big, max_batch_rows=256, reuse=cf_c)
    np.testing.assert_array_equal(cf_d.predict(X[:30]),
                                  _fresh(big).predict(X[:30]))


def test_dead_forest_raises_and_the_booster_falls_back(binary_model,
                                                       other_binary_model):
    bst, X = binary_model
    want = _fresh(bst).predict(X[:10])
    cf_old = bst.compile(max_batch_rows=256)
    compile_forest(other_binary_model, max_batch_rows=256, reuse=cf_old)
    assert cf_old._dead
    assert not cf_old.matches(cf_old.lo, cf_old.hi, cf_old.total_trees)
    np.testing.assert_array_equal(bst.predict(X[:10]), want)


# ---- the micro-batcher -----------------------------------------------------

def test_batcher_resolves_concurrent_requests(binary_model):
    """8 threads, each 20 requests of 1-64 rows: every future resolves to
    the direct result."""
    bst, X = binary_model
    cf = compile_forest(bst, max_batch_rows=256)
    cf.warmup()
    mb = MicroBatcher(cf, batch_window_ms=2.0, max_batch_rows=256)
    errors = []

    def client(seed):
        rs = np.random.RandomState(seed)
        for _ in range(20):
            n = int(rs.randint(1, 65))
            lo = int(rs.randint(0, len(X) - n))
            got = mb.submit(X[lo:lo + n]).result(timeout=30)
            if not np.array_equal(got, cf.predict_raw(X[lo:lo + n])):
                errors.append((seed, lo, n))

    threads = [threading.Thread(target=client, args=(s,))
               for s in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        st = mb.stats()
    finally:
        mb.close()
    assert not errors
    assert st["requests_total"] == 160 and st["queue_depth_rows"] == 0
    assert st["batches_total"] <= 160 and st["p50_ms"] is not None


class _Gated:
    """A forest whose device call waits for ``release``."""

    def __init__(self, inner=None, n_features=4):
        self.inner = inner
        self.n_features = inner.n_features if inner else n_features
        self.release = threading.Event()

    def predict_raw(self, X):
        assert self.release.wait(timeout=30)
        if self.inner is None:
            return np.zeros((X.shape[0], 1), np.float32)
        return self.inner.predict_raw(X)


def test_batcher_backpressure(binary_model):
    bst, X = binary_model
    slow = _Gated(compile_forest(bst, max_batch_rows=256))
    mb = MicroBatcher(slow, batch_window_ms=0.0, max_batch_rows=8,
                      queue_max_rows=32)
    try:
        first = mb.submit(X[:8])
        time.sleep(0.05)
        second = mb.submit(X[:16])
        with pytest.raises(QueueFullError):
            mb.submit(X[:16])
        assert mb.stats()["rejected_total"] == 1
        slow.release.set()
        first.result(timeout=30)
        second.result(timeout=30)
    finally:
        slow.release.set()
        mb.close()
    with pytest.raises(ValueError, match="features"):
        MicroBatcher(slow).submit(np.zeros((2, slow.n_features + 1)))


def test_batcher_sheds_the_oldest_on_queue_depth():
    forest = _Gated()
    mb = MicroBatcher(forest, batch_window_ms=0.0, max_batch_rows=4,
                      queue_max_rows=4096, shed_queue_rows=8)
    try:
        X = np.zeros((4, 4), np.float32)
        first = mb.submit(X)
        time.sleep(0.2)
        backlog = [mb.submit(X) for _ in range(5)]
        forest.release.set()
        outcomes = []
        for fut in backlog:
            try:
                fut.result(timeout=30)
                outcomes.append("ok")
            except SheddingError:
                outcomes.append("shed")
        assert first.result(timeout=30).shape == (4, 1)
        assert outcomes.count("shed") >= 2 and outcomes[-1] == "ok"
        assert outcomes == sorted(outcomes, key=lambda o: o == "ok")
        st = mb.stats()
        assert st["shed_total"] == outcomes.count("shed")
        assert st["shed_rows"] == 4 * outcomes.count("shed")
    finally:
        forest.release.set()
        mb.close()


def test_batcher_sheds_a_blown_latency_budget():
    forest = _Gated()
    mb = MicroBatcher(forest, batch_window_ms=0.0, max_batch_rows=4,
                      queue_max_rows=4096, shed_p99_ms=50.0)
    try:
        X = np.zeros((2, 4), np.float32)
        first = mb.submit(X)
        time.sleep(0.1)
        stale = mb.submit(X)
        time.sleep(0.2)
        forest.release.set()
        assert first.result(timeout=30) is not None
        with pytest.raises(SheddingError, match="latency budget"):
            stale.result(timeout=30)
        assert mb.submit(X).result(timeout=30).shape == (2, 1)
    finally:
        forest.release.set()
        mb.close()


@pytest.mark.parametrize("deferred", [False, True])
def test_swap_drops_no_request(binary_model, other_binary_model, deferred):
    """Requests in flight across a swap (a plain one, or a staged forest
    attached in place on the worker) all resolve, each to one model's
    answer; later ones to the new model's."""
    bst, X = binary_model
    cf_a = compile_forest(bst, max_batch_rows=256)
    cf_a.warmup(64)
    a_ref = cf_a.predict_raw(X[:4])
    cf_b = compile_forest(other_binary_model, max_batch_rows=256,
                          stage=deferred)
    b_ref = _fresh(other_binary_model).predict(X[:4], raw_score=True)[:, None]
    assert not np.allclose(a_ref, b_ref)
    mb = MicroBatcher(cf_a, batch_window_ms=0.5, max_batch_rows=64)
    results, lock, stop = [], threading.Lock(), threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                fut = mb.submit(X[:4])
            except QueueFullError:
                continue
            out = fut.result(timeout=30)
            with lock:
                results.append(out)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        if deferred:
            mb.swap_deferred(lambda old: cf_b.attach(reuse=old)).result(
                timeout=30)
            assert cf_a._dead
        else:
            mb.swap(cf_b)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        mb.close()
    assert results
    seen_b = 0
    for out in results:
        is_a = np.array_equal(out, a_ref)
        is_b = np.array_equal(out, b_ref)
        assert is_a or is_b
        seen_b += is_b
    assert seen_b and np.array_equal(results[-1], b_ref)
    assert mb.stats()["swaps_total"] == 1

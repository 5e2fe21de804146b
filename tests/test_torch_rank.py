"""Learning to rank in the port (lightgbm_tpu_torch: Dataset groups and
positions, ranking.py's lambdarank and rank_xendcg objectives and its
NDCG@k and MAP@k functions) held against the JAX package on the CPU.

- ``_lambdarank_grads`` on queries of 1 to 40 documents (all-zero-label
  queries, all-equal scores, truncation below the query size,
  ``lambdarank_norm`` on and off, weights, ``label_gain``): allclose at
  rtol=1e-5, atol=1e-6. The port pads each query to the power of two at
  or above its size, JAX to the longest query, so only the float
  summation order of the sums may differ;
- position-debiased lambdarank over 3 iterations: the same biases;
- ``rank_xendcg`` gradients, NDCG@k and MAP@k;
- ``lgb.train`` end to end on examples/generate_data.py's lambdarank
  shape: identical trees, NDCG@10 within 1e-3;
- the reference model file ``tests/data/rank.model.txt``.

Every test passes ``device_type="cpu"`` to the port.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import ranking as jrank
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu_torch import ranking as trank
from lightgbm_tpu_torch.config import Config

DATA = Path(__file__).resolve().parent / "data"
CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the test workers share the machine's cores, and
    these tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Drop the JAX programs this module compiled (configurations no
    other test uses) when it ends, so that they do not count against the
    process-wide jit signature budgets that later tests on the same
    worker check."""
    yield
    jax.clear_caches()


def _generated(n_query=300, per_q=15, f=10, seed=4):
    """examples/generate_data.py's lambdarank data, in memory: graded
    relevance 0-4 by within-query rank of a noisy linear score."""
    rs = np.random.RandomState(seed)
    n = n_query * per_q
    X = rs.randn(n, f)
    rel = X[:, 0] + 0.5 * X[:, 3] + 0.4 * rs.randn(n)
    y = np.zeros(n)
    for q in range(n_query):
        s = slice(q * per_q, (q + 1) * per_q)
        order = np.argsort(-rel[s])
        grades = np.zeros(per_q)
        grades[order[:2]] = [4, 3]
        grades[order[2:5]] = 2
        grades[order[5:8]] = 1
        y[s] = grades
    return X, y, np.full(n_query, per_q, np.int64)


def _ragged_queries(seed=0):
    """Queries of 1 to 40 documents (every size, shuffled), labels 0-4
    with most at 0, two all-zero-label queries, one single-document
    query, ties in the scores."""
    rs = np.random.RandomState(seed)
    sizes = rs.permutation(np.arange(1, 41))
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(qb[-1])
    label = np.minimum(rs.geometric(0.45, n) - 1, 4).astype(np.float32)
    for q in (3, 17):
        label[qb[q]:qb[q + 1]] = 0
    score = np.round(rs.randn(n), 1).astype(np.float32)
    return qb, label, score


def _jax_grads(score, qb, label, weight, cfg, sigma, trunc, norm):
    idx, mask, _ = jrank._pad_queries(qb)
    gains = jrank._label_gains(cfg, int(label.max()))
    gor = jnp.asarray(gains[label.astype(np.int64)], jnp.float32)
    g, h = jrank._lambdarank_grads(
        jnp.asarray(score), jnp.asarray(idx), jnp.asarray(mask), gor,
        None if weight is None else jnp.asarray(weight), jnp.float32(sigma),
        trunc=trunc, norm=norm, blk=7)
    return np.asarray(g), np.asarray(h)


def _port_grads(score, qb, label, weight, label_gain, sigma, trunc, norm):
    gains = trank._label_gains(label_gain, int(label.max()))
    gor = torch.as_tensor(gains[label.astype(np.int64)], dtype=torch.float32)
    g, h = trank._lambdarank_grads(
        torch.from_numpy(score), trank._pad_queries(qb, "cpu"), gor,
        None if weight is None else torch.from_numpy(weight), sigma, trunc,
        norm)
    return g.numpy(), h.numpy()


@pytest.mark.parametrize("case", [
    dict(),
    dict(norm=False),
    dict(trunc=5),
    dict(weighted=True, sigma=1.5),
    dict(label_gain=[0.0, 1.0, 2.5, 6.0, 11.0, 20.0], trunc=12),
    dict(tied=True),
    dict(tied=True, norm=False, trunc=3),
])
def test_lambdarank_grads_match_jax(case):
    qb, label, score = _ragged_queries()
    if case.get("tied"):
        score = np.zeros_like(score)         # iteration 0: all equal
    w = np.random.RandomState(1).rand(len(label)).astype(np.float32) + 0.5 \
        if case.get("weighted") else None
    lg = case.get("label_gain", [])
    sigma, trunc = case.get("sigma", 1.0), case.get("trunc", 30)
    norm = case.get("norm", True)
    cfg = JaxConfig.from_params({"objective": "lambdarank",
                                 "label_gain": lg})
    jg, jh = _jax_grads(score, qb, label, w, cfg, sigma, trunc, norm)
    tg, th = _port_grads(score, qb, label, w, lg, sigma, trunc, norm)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    # the all-zero-label queries and the one-document query get nothing
    for q in (3, 17, int(np.nonzero(np.diff(qb) == 1)[0][0])):
        assert not tg[qb[q]:qb[q + 1]].any()


def test_query_buckets_cover_every_row_once():
    qb, _, _ = _ragged_queries()
    buckets = trank._pad_queries(qb, "cpu")
    assert [b.P for b in buckets] == [1, 2, 4, 8, 16, 32, 64]
    rows = torch.cat([b.rows for b in buckets]).sort().values
    assert torch.equal(rows, torch.arange(int(qb[-1])))
    qids = torch.cat([b.qids for b in buckets]).sort().values
    assert torch.equal(qids, torch.arange(len(qb) - 1))
    for b in buckets:
        assert b.blk == min(len(b.qids), trank.PAIR_BUDGET // b.P ** 2)


def _dataset_pair(X, y, group, **kw):
    return (jlgb.Dataset(X, label=y, group=group, **kw),
            tlgb.Dataset(X, label=y, group=group, **kw))


def test_rank_xendcg_grads_match_jax():
    qb, label, score = _ragged_queries(2)
    w = np.random.RandomState(3).rand(len(label)).astype(np.float32) + 0.5
    X = np.random.RandomState(4).randn(len(label), 3)
    jd, td = _dataset_pair(X, label, np.diff(qb),
                           params={"verbosity": -1})
    td.params.update(CPU)
    jo = jrank.create_ranking_objective(
        JaxConfig.from_params({"objective": "rank_xendcg"}))
    to = trank.create_ranking_objective(
        Config.from_params({"objective": "rank_xendcg"}))
    jo.set_dataset(jd)
    to.set_dataset(td)
    for weight in (None, w):
        jg, jh = jo.grad_hess(jnp.asarray(score), jnp.asarray(label),
                              None if weight is None else jnp.asarray(weight))
        tg, th = to.grad_hess(torch.from_numpy(score),
                              torch.from_numpy(label),
                              None if weight is None
                              else torch.from_numpy(weight))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-6)


class _Queries:
    def __init__(self, qb):
        self.qb = qb

    def query_boundaries(self):
        return self.qb


@pytest.mark.parametrize("k", [1, 3, 10])
def test_ndcg_and_map_match_jax(k):
    qb, label, score = _ragged_queries(5)
    cfg = JaxConfig.from_params({"objective": "lambdarank", "eval_at": [k]})
    args = (jnp.asarray(score), jnp.asarray(label), None, _Queries(qb), None)
    want_ndcg = float(jrank.NDCGMetric(cfg, k).eval_with_query(*args))
    want_map = float(jrank.MapMetric(cfg, k).eval_with_query(*args))
    s, lab = torch.from_numpy(score), torch.from_numpy(label)
    assert abs(trank.ndcg_at_k(s, lab, qb, k) - want_ndcg) < 1e-6
    assert abs(trank.map_at_k(s, lab, qb, k) - want_map) < 1e-6
    lg = [0.0, 1.0, 3.0, 7.5, 9.0]
    cfg = JaxConfig.from_params({"objective": "lambdarank", "label_gain": lg})
    want = float(jrank.NDCGMetric(cfg, k).eval_with_query(*args))
    assert abs(trank.ndcg_at_k(s, lab, qb, k, lg) - want) < 1e-6


def _same_trees(ja, tb):
    assert len(tb._models) == len(ja._models)
    for a, b in zip(ja._models, tb._models):
        assert a.num_leaves == b.num_leaves
        for name in ("split_feature", "threshold_bin", "threshold",
                     "left_child", "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_end_to_end_matches_jax(objective, tmp_path):
    X, y, group = _generated()
    p = {"objective": objective, "num_leaves": 15, "verbosity": -1}
    jd, td = _dataset_pair(X, y, group)
    ja = jlgb.train({**p, "hist_method": "scatter"}, jd, num_boost_round=3)
    tb = tlgb.train({**p, **CPU}, td, num_boost_round=3)
    _same_trees(ja, tb)
    np.testing.assert_array_equal(tb.predict(X, pred_leaf=True),
                                  ja.predict(X, pred_leaf=True))
    pj, pt = ja.predict(X), tb.predict(X)
    assert pt.shape == (len(y),)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-5)
    qb = td.query_boundaries()
    yt = torch.from_numpy(y)
    ndcg_t = trank.ndcg_at_k(torch.from_numpy(pt), yt, qb, 10)
    ndcg_j = trank.ndcg_at_k(torch.from_numpy(pj), yt, qb, 10)
    assert ndcg_t > 0.6 and abs(ndcg_t - ndcg_j) < 1e-3
    tb.save_model(tmp_path / "port.txt")
    ja.save_model(str(tmp_path / "jax.txt"))
    assert f"objective={objective}" in (tmp_path / "port.txt").read_text()
    np.testing.assert_allclose(
        jlgb.Booster(model_file=str(tmp_path / "port.txt")).predict(X), pt,
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tlgb.Booster(model_file=str(tmp_path / "jax.txt"),
                     params=CPU).predict(X), pj, rtol=0, atol=1e-6)


def test_position_debiased_lambdarank_matches_jax():
    X, y, group = _generated(n_query=120, per_q=12, seed=6)
    position = np.tile(np.arange(12), len(y) // 12)
    p = {"objective": "lambdarank", "num_leaves": 10, "verbosity": -1,
         "lambdarank_position_bias_regularization": 0.1}
    jd, td = _dataset_pair(X, y, group, position=position)
    ja = jlgb.train({**p, "hist_method": "scatter"}, jd, num_boost_round=3)
    tb = tlgb.train({**p, **CPU}, td, num_boost_round=3)
    jo, to = ja._engine.objective, tb._engine.objective
    assert to.num_pos == jo.num_pos == 12
    want = np.asarray(jo.pos_biases)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(to.pos_biases.numpy(), want, rtol=1e-5,
                               atol=1e-6)
    _same_trees(ja, tb)


def test_reference_model_file_predicts_like_jax():
    path = str(DATA / "rank.model.txt")
    jb = jlgb.Booster(model_file=path)
    tb = tlgb.Booster(model_file=path, params=CPU)
    rs = np.random.RandomState(12)
    X = rs.rand(500, 301)
    X[rs.rand(500, 301) < 0.05] = np.nan
    p = tb.predict(X)
    assert p.shape == (500,)
    np.testing.assert_allclose(p, jb.predict(X), rtol=1e-6, atol=1e-5)


def test_groups_and_positions_match_jax():
    X, y, group = _generated(n_query=20, per_q=6)
    jd, td = _dataset_pair(X, y, group, position=np.arange(len(y)) % 6)
    td.params.update(CPU)
    assert td.query_boundaries().dtype == np.int64
    np.testing.assert_array_equal(td.query_boundaries(),
                                  jd.query_boundaries())
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    np.testing.assert_array_equal(td.get_position(), jd.get_position())
    td.set_group(np.full(10, 12))
    jd.set_group(np.full(10, 12))
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    td.set_position(None)
    assert td.get_position() is None


def test_group_sizes_must_sum_to_the_rows():
    X, y, group = _generated(n_query=10, per_q=5)
    bad = group.copy()
    bad[0] += 1
    with pytest.raises(jlgb.basic.LightGBMError) as want:
        jlgb.Dataset(X, label=y, group=bad).construct()
    with pytest.raises(tlgb.LightGBMError) as got:
        tlgb.Dataset(X, label=y, group=bad, params=CPU).construct()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="query information"):
        tlgb.train({"objective": "lambdarank", **CPU},
                   tlgb.Dataset(X, label=y), 1)

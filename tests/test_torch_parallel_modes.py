"""Feature- and voting-parallel training, the sharded split search, the
quantized histogram wire, ``tree_learner=auto``, metrics and continued
training of the port in a gloo world of two CPU ranks (the cases of
``tests/test_parallel_modes.py``, ``tests/test_comms.py`` and
``tests/test_sharding.py``; bundling, forced splits and the refusals in
``tests/test_torch_parallel_bundled.py``).

One world runs every training of this module (``_torch_world.py``),
beside the JAX oracles. Feature-parallel rows are replicated, so its
trees equal the port's one-process run exactly; float trees against the
JAX mesh at ``num_devices=2`` are held as ``tests/test_parallel_modes.py``
holds them; every rank's model text is byte-equal (``World.booster``).
"""

import types

import jax
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from _torch_world import CPU, World, close_trees, trees_text
from conftest import make_synthetic_binary

D = 2
BIN = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
       "verbosity": -1}


def _one_rank(params, X, y, rounds, **kw):
    return tlgb.train({**params, **CPU},
                      tlgb.Dataset(X, label=y, params=CPU, **kw), rounds)


def _bag_cat():
    rs = np.random.RandomState(5)
    n = 3000
    Xc = rs.randint(0, 6, size=(n, 1)).astype(float)
    Xn = rs.randn(n, 6)
    X = np.hstack([Xc, Xn])
    y = ((Xc[:, 0] % 2 == 0) ^ (Xn[:, 1] > 0)).astype(float)
    return X, y


def _unaligned():
    rs = np.random.RandomState(13)
    X = rs.randn(3000, 34)
    y = ((X[:, 32] + 0.3 * X[:, 5]) > 0).astype(float)
    return X, y


def _skewed():
    rs = np.random.RandomState(29)
    n, f = 8192, 16
    X = rs.randn(n, f)
    y = ((X[:, 2] + 0.6 * X[:, 7] + 0.3 * X[:, 11]
          + 0.2 * rs.randn(n)) > 0).astype(float)
    w = np.zeros(n)
    w[:1024] = 1.0
    w[1024::64] = 1.0
    return X, y, w


QUANT = {"use_quantized_grad": True, "stochastic_rounding": False,
         "num_grad_quant_bins": 16}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(D, tmp_path_factory.mktemp("world2"))
    X, y = make_synthetic_binary(n=4000, f=11, seed=7)
    w.add("feature", X, y, {**BIN, "tree_learner": "feature"}, 6)
    X, y = make_synthetic_binary(n=4000, f=9, seed=3)
    w.add("data9", X, y, {**BIN, "tree_learner": "data"}, 6)
    w.add("voting_full", X, y, {**BIN, "tree_learner": "voting",
                                "top_k": 9}, 6)
    w.add("data9_q", X, y, {**BIN, **QUANT, "tree_learner": "data"}, 6)
    w.add("voting_full_q", X, y, {**BIN, **QUANT, "tree_learner": "voting",
                                  "top_k": 9}, 6)
    w.add("data9_sharded", X, y, {**BIN, "tree_learner": "data",
                                  "split_search": "sharded"}, 6)
    rs = np.random.RandomState(11)
    Xr = rs.randn(4000, 16)
    yr = ((Xr[:, 0] + 0.5 * Xr[:, 3] + 0.25 * Xr[:, 9]) > 0).astype(float)
    w.add("voting_k3", Xr, yr, {**BIN, "tree_learner": "voting",
                                "top_k": 3}, 10)
    X, y = _bag_cat()
    w.add("feature_bag_cat", X, y, {**BIN, "tree_learner": "feature",
                                    "bagging_fraction": 0.8,
                                    "bagging_freq": 1,
                                    "categorical_feature": [0]}, 5,
          categorical_feature=[0])
    X, y = _unaligned()
    w.add("feature_34", X, y, {**BIN, "tree_learner": "feature"}, 6)
    X, y, wt = _skewed()
    for mode in ("data", "voting"):
        w.add(f"skewed_{mode}", X, y, {**BIN, "top_k": 3,
                                       "tree_learner": mode}, 8, weight=wt)
    X, y = make_synthetic_binary(n=4000, f=11, seed=7)
    for hc in ("f32", "int16", "int8"):
        w.add(f"wire_{hc}", X, y, {**BIN, "tree_learner": "data",
                                   "hist_comm": hc}, 5)
    w.add("wire_int8_again", X, y, {**BIN, "tree_learner": "data",
                                    "hist_comm": "int8"}, 5)
    w.add("auto", X, y, {**BIN, "tree_learner": "auto"}, 5)
    w.add("evaluated", X, y, {**BIN, "tree_learner": "data",
                              "metric": "auc,binary_logloss"}, 4,
          evaluate=True)
    w.add("continued", X, y, {**BIN, "tree_learner": "data"}, 3,
          more_rounds=2)
    w.start()
    yield w
    w.kill()


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


def test_feature_parallel_matches_serial_and_the_jax_mesh(world):
    X, y = make_synthetic_binary(n=4000, f=11, seed=7)
    # the JAX oracles first, so they compile while the world trains
    jm = jlgb.train({**BIN, "tree_learner": "feature", "num_devices": D},
                    jlgb.Dataset(X, label=y), 6)
    got = world.booster("feature")
    assert trees_text(got.model_to_string()) \
        == trees_text(_one_rank(BIN, X, y, 6).model_to_string())
    # against the JAX package: test_data_parallel._trees_equal's values
    close_trees(got, jm, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name,data,extra", [
    ("feature_bag_cat", _bag_cat, {"bagging_fraction": 0.8,
                                   "bagging_freq": 1,
                                   "categorical_feature": [0]}),
    ("feature_34", _unaligned, {})])
def test_feature_parallel_equals_one_rank(world, name, data, extra):
    """Replicated rows: the same draws, the same histograms, the owned
    columns' records combined to the serial search's winner."""
    X, y = data()
    kw = {"categorical_feature": [0]} if extra.get("categorical_feature") \
        else {}
    one = _one_rank({**BIN, **extra}, X, y, 5 if kw else 6, **kw)
    assert trees_text(world.booster(name).model_to_string()) \
        == trees_text(one.model_to_string())


def _jax_mesh(params, X, y, rounds, **kw):
    return jlgb.train({**params, "num_devices": D},
                      jlgb.Dataset(X, label=y, **kw), rounds)


@pytest.mark.parametrize("name", ["data9", "voting_k3"])
def test_world_matches_the_jax_mesh(world, name):
    """Data-parallel training and restricted voting (``top_k=3`` of 16)
    against the JAX mesh at ``num_devices=2`` with the same rows per
    device: each rank's ballot, the election and the elected features'
    reduction as the JAX grower runs them (float trees as
    ``test_feature_parallel_matches_serial_and_the_jax_mesh`` holds
    them)."""
    if name == "data9":
        X, y = make_synthetic_binary(n=4000, f=9, seed=3)
        jm = _jax_mesh({**BIN, "tree_learner": "data"}, X, y, 6)
    else:
        rs = np.random.RandomState(11)
        X = rs.randn(4000, 16)
        y = ((X[:, 0] + 0.5 * X[:, 3] + 0.25 * X[:, 9]) > 0).astype(float)
        jm = _jax_mesh({**BIN, "tree_learner": "voting", "top_k": 3}, X, y,
                       10)
    close_trees(world.booster(name), jm, rtol=2e-4, atol=2e-4)


def test_skewed_voting_matches_the_jax_mesh_to_its_near_tie(world):
    """Voting on count-skewed shards against the JAX mesh at
    ``num_devices=2``. The first tree is the JAX tree; in the second, a
    leaf's local gains on the near-empty rank fall into two values one
    float rounding apart (0.00966382 and 0.009664059: equal in exact
    arithmetic, summed in other orders), and its ballot takes the other
    half of the tie (ROADMAP Queue 3, near ties in a world). So the rest
    is held to the float standard of the card: every tree's root split,
    and the quality."""
    X, y, w = _skewed()
    jm = _jax_mesh({**BIN, "tree_learner": "voting", "top_k": 3}, X, y, 8,
                   weight=w)
    got = world.booster("skewed_voting")
    close_trees(_first_tree(got), _first_tree(jm), rtol=2e-4, atol=2e-4)
    for ta, tb in zip(got._models, jm._models):
        assert ta.split_feature[0] == tb.split_feature[0]
        assert abs(ta.threshold[0] - tb.threshold[0]) <= 1e-6
    mask = w > 0
    acc = [np.mean((b.predict(X[mask]) > 0.5) == (y[mask] > 0.5))
           for b in (got, jm)]
    assert abs(acc[0] - acc[1]) <= 0.005, acc


def _first_tree(bst):
    return types.SimpleNamespace(_models=bst._models[:1])


def test_voting_full_vote_matches_data_parallel(world):
    """2 * top_k >= F elects every feature: float trees as the JAX test
    holds them; quantized ones (exact integer sums) byte for byte."""
    close_trees(world.booster("data9"), world.booster("voting_full"))
    assert trees_text(world.booster("data9_q").model_to_string()) \
        == trees_text(world.booster("voting_full_q").model_to_string())


def test_voting_restricted_vote_trains(world):
    rs = np.random.RandomState(11)
    X = rs.randn(4000, 16)
    y = ((X[:, 0] + 0.5 * X[:, 3] + 0.25 * X[:, 9]) > 0).astype(float)
    p = world.booster("voting_k3").predict(X)
    assert np.all(np.isfinite(p))
    assert np.mean((p > 0.5) == (y > 0.5)) > 0.85


def test_voting_count_skewed_shards_root_and_quality(world):
    """One rank holds most of the weight (rank 1: 64 weighted rows of
    4,096): every tree's root elects the data-parallel winner's feature,
    the first tree's root (the same gradients) its threshold too, and the
    quality matches. Deeper elections drift (PV-Tree's local ballots on a
    near-empty shard), so later trees start from other scores."""
    X, y, w = _skewed()
    data, voting = world.booster("skewed_data"), world.booster(
        "skewed_voting")
    assert data._models[0].threshold[0] == voting._models[0].threshold[0]
    for ta, tb in zip(data._models, voting._models):
        assert ta.split_feature[0] == tb.split_feature[0]
    mask = w > 0
    acc_d = np.mean((data.predict(X[mask]) > 0.5) == (y[mask] > 0.5))
    acc_v = np.mean((voting.predict(X[mask]) > 0.5) == (y[mask] > 0.5))
    assert acc_v > acc_d - 0.01


def test_sharded_search_byte_identical_to_gathered(world):
    assert trees_text(world.booster("data9_sharded").model_to_string()) \
        == trees_text(world.booster("data9").model_to_string())


def test_quantized_wire(world):
    """int16 within the JAX test's eval tolerance of f32; int8
    deterministic and learning; both rank-identical (World.booster). On
    the CPU too the wire is the exchange the card runs."""
    X, y = make_synthetic_binary(n=4000, f=11, seed=7)
    p32 = world.booster("wire_f32").predict(X[:500])
    p16 = world.booster("wire_int16").predict(X[:500])
    assert np.max(np.abs(p16 - p32)) < 1e-3
    a, b = world.booster("wire_int8"), world.booster("wire_int8_again")
    assert trees_text(a.model_to_string()) == trees_text(b.model_to_string())
    from sklearn.metrics import roc_auc_score
    assert roc_auc_score(y, a.predict(X)) > 0.8


def test_auto_picks_feature_for_few_rows(world):
    """4,000 rows are few enough to replicate: ``auto`` is feature-
    parallel (comms.choose_parallel_mode), equal to one rank's run."""
    X, y = make_synthetic_binary(n=4000, f=11, seed=7)
    got = world.booster("auto")
    assert trees_text(got.model_to_string()) \
        == trees_text(_one_rank(BIN, X, y, 5).model_to_string())


def test_metrics_and_continued_training_in_a_world(world):
    """The train set's metrics are the world's (scores and labels
    gathered), a replicated valid set's are every rank's alike, both as
    one process computes them; a model continued with ``init_model``
    (each rank's score rebuilt from the trees on its own rows) grows the
    one-process continuation's trees."""
    X, y = make_synthetic_binary(n=4000, f=11, seed=7)
    p = {**BIN, "metric": "auc,binary_logloss"}
    ds = tlgb.Dataset(X, label=y, params=CPU)
    want = {}
    tlgb.train({**p, **CPU}, ds, 4, valid_sets=[
        ds, tlgb.Dataset(X, label=y, reference=ds, params=CPU)],
        valid_names=["train", "valid"],
        callbacks=[tlgb.record_evaluation(want)])
    got = world.evals("evaluated")
    assert got[0] == got[1]
    for name in ("train", "valid"):
        for m in ("auc", "binary_logloss"):
            np.testing.assert_allclose(got[0][name][m], want[name][m],
                                       rtol=1e-5)
    one = _one_rank(BIN, X, y, 3)
    one = tlgb.train({**BIN, **CPU}, tlgb.Dataset(X, label=y, params=CPU),
                     2, init_model=one)
    close_trees(world.booster("continued"), one, rtol=2e-4, atol=2e-4)

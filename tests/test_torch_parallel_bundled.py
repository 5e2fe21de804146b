"""Exclusive feature bundling, forced splits and L1's leaf renewal in a
gloo world of two CPU ranks, and the refusals the port copies from the
JAX package (the bundled and forced cases of
``tests/test_data_parallel.py`` and
``tests/test_parallel_modes.py``, ``tests/test_sharding.py``'s EFB
fallback).

One world runs every training of this module (``_torch_world.py``),
beside the JAX oracles; every rank's model text is byte-equal
(``World.booster``).
"""

import jax
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from _torch_world import (CPU, World, close_trees, sparse_onehot, trees_equal,
                          trees_text)
from conftest import make_synthetic_binary, make_synthetic_regression

D = 2
BIN = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
       "verbosity": -1}
BUNDLE = {**BIN, "enable_bundle": True}
FORCED = {"objective": "binary", "num_leaves": 8, "verbosity": -1,
          "min_data_in_leaf": 5}
L1 = {"objective": "regression_l1", "num_leaves": 15, "min_data_in_leaf": 10,
      "verbosity": -1}


@pytest.fixture(scope="module")
def forced_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("forced") / "forced.json"
    path.write_text('{"feature": 1, "threshold": 0.0}')
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory, forced_path):
    w = World(D, tmp_path_factory.mktemp("world2b"))
    X, y = sparse_onehot(4096, 4, 6, 11)
    for mode in ("data", "feature"):
        w.add(f"bundled_{mode}", X, y, {**BUNDLE, "tree_learner": mode}, 5)
    w.add("bundled_sharded", X, y, {**BUNDLE, "tree_learner": "data",
                                    "split_search": "sharded"}, 5)
    X, y = sparse_onehot(4096, 3, 5, 33)
    for mode in ("data", "voting"):
        w.add(f"bundled3_{mode}", X, y, {**BUNDLE, "tree_learner": mode,
                                         "top_k": 20}, 6)
    X, y = make_synthetic_binary(n=3000, f=5, seed=13)
    w.add("forced", X, y, {**FORCED, "forcedsplits_filename": forced_path,
                           "tree_learner": "data"}, 3)
    w.add("voting_forced", X, y, {**FORCED, "tree_learner": "voting",
                                  "forcedsplits_filename": forced_path}, 1,
          expect_error=True)
    w.add("devices3", X, y, {**FORCED, "tree_learner": "data",
                             "num_devices": 3}, 1, expect_error=True)
    w.add("cegb", X, y, {**FORCED, "tree_learner": "data",
                         "cegb_penalty_split": 0.1}, 1, expect_error=True)
    X, y = make_synthetic_regression(n=4000, f=8, seed=15)
    w.add("regression_l1", X, y, {**L1, "tree_learner": "data"}, 4)
    w.start()
    yield w
    w.kill()


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


def test_bundled_worlds(world):
    """EFB under every mode: data-parallel against the JAX mesh's bundled
    trees, feature-parallel equal to one rank's, a sharded search falling
    back to the gathered one (byte for byte), and a full-vote voting run
    equal in structure to data-parallel."""
    X, y = sparse_onehot(4096, 4, 6, 11)
    # the JAX oracle first, so it compiles while the world trains
    jm = jlgb.train({**BUNDLE, "tree_learner": "data", "num_devices": D},
                    jlgb.Dataset(X, label=y), 5)
    assert jm._engine.bundle is not None
    data = world.booster("bundled_data")
    close_trees(data, jm, rtol=2e-4, atol=2e-4, thresholds=False)
    one = tlgb.train({**BUNDLE, **CPU}, tlgb.Dataset(X, label=y,
                                                     params=CPU), 5)
    assert trees_text(world.booster("bundled_feature").model_to_string()) \
        == trees_text(one.model_to_string())
    assert trees_text(world.booster("bundled_sharded").model_to_string()) \
        == trees_text(data.model_to_string())
    close_trees(world.booster("bundled3_data"),
                world.booster("bundled3_voting"), rtol=1e-4, atol=1e-4)


def test_forced_splits_and_refusals(world, forced_path):
    X, y = make_synthetic_binary(n=3000, f=5, seed=13)
    jm = jlgb.train({**FORCED, "forcedsplits_filename": forced_path,
                     "tree_learner": "data", "num_devices": D},
                    jlgb.Dataset(X, label=y), 3)
    got = world.booster("forced")
    assert all(int(t.split_feature[0]) == 1 for t in got._models)
    close_trees(got, jm, rtol=2e-4, atol=2e-4)
    assert "does not support forced splits" in world.error("voting_forced")
    err = world.error("devices3")
    assert "num_devices=3" in err and "launch 3" in err
    assert "CEGB is not supported with multi-device" in world.error("cegb")


def test_l1_renewal_percentiles_of_the_worlds_residuals(world):
    """L1's leaf renewal takes percentiles of the world's residuals (each
    rank's gathered), as the JAX mesh takes them over every row."""
    X, y = make_synthetic_regression(n=4000, f=8, seed=15)
    jm = jlgb.train({**L1, "tree_learner": "data", "num_devices": D},
                    jlgb.Dataset(X, label=y), 4)
    trees_equal(world.booster("regression_l1"), jm)

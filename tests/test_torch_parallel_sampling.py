"""Data-parallel training of the port with sampling, constraints and
categorical features, in a gloo world of four CPU ranks, held against the
JAX package's mesh training at ``num_devices=4`` (the remaining cases of
``tests/test_data_parallel.py`` and their kin).

One world runs every training of this module (``_torch_world.py``),
beside the JAX oracles. The port's bagging and GOSS draws are replaced
by the JAX package's (each rank draws the whole world's vector and takes
its own rows, so the bag is the one-process one). Float trees are held
as ``tests/test_data_parallel.py`` holds them; every rank's model text
is byte-equal (``World.booster``).
"""

import jax
import numpy as np
import pytest

import lightgbm_tpu as jlgb
from _torch_world import World, trees_equal
from conftest import make_synthetic_binary, make_synthetic_regression

D = 4
JAX_MESH = {"tree_learner": "data", "num_devices": D}
BIN = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
       "verbosity": -1}


def _categorical():
    rs = np.random.RandomState(9)
    n = 3000
    Xc = rs.randint(0, 12, size=(n, 2)).astype(np.float64)
    Xn = rs.randn(n, 4)
    X = np.concatenate([Xc, Xn], axis=1)
    y = ((Xc[:, 0] % 3 == 0) ^ (Xn[:, 0] > 0)).astype(np.float64)
    return X, y


def _bag_draws(n, rounds, bagging_seed=3):
    """The JAX package's bagging draws, one ``[n]`` row per iteration."""
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(
        jax.random.PRNGKey(bagging_seed), it), (n,))) for it in
        range(rounds)]).astype(np.float32)


CASES = {
    "monotone": (lambda: make_synthetic_regression(n=3000, f=5, seed=11),
                 {"objective": "regression", "num_leaves": 15,
                  "verbosity": -1, "min_data_in_leaf": 5,
                  "monotone_constraints": [1, -1, 0, 0, 0]}, 5),
    "bagging": (lambda: make_synthetic_binary(n=4000, f=6, seed=12),
                {**BIN, "bagging_fraction": 0.6, "bagging_freq": 1,
                 "seed": 7}, 5),
    # GOSS's threshold is over the world's rows (gathered)
    "goss": (lambda: make_synthetic_binary(n=4000, f=6, seed=14),
             {**BIN, "data_sample_strategy": "goss",
              "learning_rate": 0.5}, 5),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(D, tmp_path_factory.mktemp("world4s"))
    for name, (data, params, rounds) in CASES.items():
        X, y = data()
        draws = _bag_draws(len(y), rounds) \
            if name in ("bagging", "goss") else None
        w.add(name, X, y, {**params, "tree_learner": "data"}, rounds,
              draws=draws)
    X, y = _categorical()
    w.add("categorical", X, y, {**BIN, "tree_learner": "data"}, 4,
          categorical_feature=[0, 1])
    w.start()
    yield w
    w.kill()


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", sorted(CASES))
def test_world_matches_the_jax_mesh(world, name):
    data, params, rounds = CASES[name]
    X, y = data()
    jm = jlgb.train({**params, **JAX_MESH}, jlgb.Dataset(X, label=y),
                    rounds)
    trees_equal(world.booster(name), jm)


def test_categorical_accuracy_parity(world):
    """``test_dp_categorical_accuracy_parity``'s standard: the mesh's
    shard sums perturb the categorical ratios at f32 epsilon, so the
    predictions' accuracy is held, not the trees."""
    X, y = _categorical()
    jm = jlgb.train({**BIN, **JAX_MESH, "categorical_feature": [0, 1]},
                    jlgb.Dataset(X, label=y), 4)
    got = world.booster("categorical")
    acc_w = np.mean((got.predict(X) > 0.5) == y)
    acc_j = np.mean((jm.predict(X) > 0.5) == y)
    assert abs(acc_w - acc_j) < 0.02 and acc_w > 0.9

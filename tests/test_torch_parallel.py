"""Data-parallel training of the port in a gloo world of four CPU ranks,
held against the JAX package's mesh training at ``num_devices=4`` on the
virtual devices of ``conftest.py`` (the cases of
``tests/test_data_parallel.py``; sampling, constraints, categorical
features and renewal in ``tests/test_torch_parallel_sampling.py``).

One world runs every training of this module (``_torch_world.py``); it
starts with the module and runs beside the JAX oracles. Standards:

- float trees as ``test_data_parallel._trees_equal`` holds them:
  structure exact, thresholds to 1e-6, leaf values to 2e-4;
- quantized trees equal tree for tree to the port's own one-process run;
- every rank's model text byte-equal (``World.booster``).
"""

import jax
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from _torch_world import CPU, World, trees_equal, trees_text
from conftest import make_synthetic_binary, make_synthetic_regression

D = 4
JAX_MESH = {"tree_learner": "data", "num_devices": D}


def _multiclass():
    rs = np.random.RandomState(8)
    X = rs.randn(3000, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int) \
        + (X[:, 2] > 0.5).astype(int)
    return X, y.astype(float)


BIN = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
       "verbosity": -1}
CASES = {
    "binary": (lambda: make_synthetic_binary(n=4000, f=8, seed=5), BIN, 5),
    "regression": (lambda: make_synthetic_regression(n=4000, f=8, seed=6),
                   {"objective": "regression", "num_leaves": 31,
                    "min_data_in_leaf": 10, "verbosity": -1}, 5),
    "multiclass": (_multiclass, {"objective": "multiclass", "num_class": 3,
                                 "num_leaves": 7, "min_data_in_leaf": 5,
                                 "verbosity": -1}, 3),
    "quantized": (lambda: make_synthetic_binary(n=4000, f=6, seed=10),
                  {**BIN, "use_quantized_grad": True,
                   "stochastic_rounding": False, "num_grad_quant_bins": 16},
                  5),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(D, tmp_path_factory.mktemp("world4"))
    for name, (data, params, rounds) in CASES.items():
        X, y = data()
        w.add(name, X, y, {**params, "tree_learner": "data"}, rounds)
    # distributed_dataset's path: each rank its quarter, rank 0's mappers
    X, y = make_synthetic_binary(n=4000, f=8, seed=5)
    w.add("binary_shards", X, y, {**BIN, "tree_learner": "data"}, 5,
          dataset="shard")
    w.start()
    yield w
    w.kill()


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", ["binary", "regression", "multiclass"])
def test_world_matches_the_jax_mesh(world, name, monkeypatch):
    data, params, rounds = CASES[name]
    X, y = data()
    jm = jlgb.train({**params, **JAX_MESH}, jlgb.Dataset(X, label=y),
                    rounds)
    trees_equal(world.booster(name), jm)


def test_quantized_world_equals_one_rank_tree_for_tree(world):
    data, params, rounds = CASES["quantized"]
    X, y = data()
    one = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y,
                                                     params=CPU), rounds)
    got = world.booster("quantized")
    assert trees_text(got.model_to_string()) \
        == trees_text(one.model_to_string())
    jm = jlgb.train({**params, **JAX_MESH}, jlgb.Dataset(X, label=y),
                    rounds)
    trees_equal(got, jm)


def test_shards_bin_against_rank0_mappers(world):
    """``spmd.distributed_dataset``: the JAX mesh on the whole rows binned
    with the mappers of rank 0's quarter (``tests/test_multiprocess.py``'s
    oracle)."""
    X, y = make_synthetic_binary(n=4000, f=8, seed=5)
    ref = jlgb.Dataset(X[:1000], label=y[:1000], params={"verbosity": -1})
    ref.construct()
    jm = jlgb.train({**BIN, **JAX_MESH},
                    jlgb.Dataset(X, label=y, reference=ref), 5)
    trees_equal(world.booster("binary_shards"), jm)

"""The quantized histogram wire of a gloo world of two CPU ranks against
the JAX mesh at ``num_devices=2`` on its exchange strategy: the strategy
the port's worlds run on every device (``LIGHTGBM_TPU_COMM_EXCHANGE=1``
selects it in the JAX package, whose CPU default is its shared-scale
psum). The primitive itself is held to the JAX one in
``tests/test_torch_distributed.py::test_quantized_primitives_in_a_world_of_two``;
the wire's determinism and its distance to f32 in
``tests/test_torch_parallel_modes.py::test_quantized_wire``.
"""

import jax
import numpy as np
import pytest

import lightgbm_tpu as jlgb
from _torch_world import World, close_trees
from conftest import make_synthetic_binary

D = 2
BIN = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
       "verbosity": -1, "tree_learner": "data"}
WIRES = ("int16", "int8")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(D, tmp_path_factory.mktemp("wire2"))
    X, y = make_synthetic_binary(n=4000, f=11, seed=7)
    for hc in WIRES:
        w.add(hc, X, y, {**BIN, "hist_comm": hc}, 5)
    w.start()
    yield w
    w.kill()


@pytest.fixture(scope="module")
def jax_exchange():
    """The JAX mesh's models on the exchange; the strategy is chosen when
    a program traces, so the compiled programs go before and after."""
    X, y = make_synthetic_binary(n=4000, f=11, seed=7)
    mp = pytest.MonkeyPatch()
    mp.setenv("LIGHTGBM_TPU_COMM_EXCHANGE", "1")
    jax.clear_caches()
    try:
        yield {hc: jlgb.train({**BIN, "hist_comm": hc, "num_devices": D},
                              jlgb.Dataset(X, label=y), 5) for hc in WIRES}
    finally:
        mp.undo()
        jax.clear_caches()


def test_int16_wire_matches_the_jax_exchange(world, jax_exchange):
    """Float trees as the JAX tests hold them. One threshold sits on the
    other side of an empty bin (an equivalent threshold: ROADMAP Queue
    3), so thresholds are held through the predictions."""
    X, _ = make_synthetic_binary(n=4000, f=11, seed=7)
    got, want = world.booster("int16"), jax_exchange["int16"]
    close_trees(got, want, rtol=2e-4, atol=2e-4, thresholds=False)
    np.testing.assert_allclose(got.predict(X), want.predict(X), rtol=1e-4,
                               atol=1e-4)


def test_int8_wire_matches_the_jax_exchange(world, jax_exchange):
    """int8's 127 steps turn the last bits of a local histogram (and
    XLA's fused multiply-add in the dequantized sum) into a step of a
    small bin now and then, so the trees part from the third split of the
    first tree (ROADMAP Queue 3, the int8 wire). Held to the first root
    split and to the JAX run's AUC (5e-5 apart on this fixture)."""
    from sklearn.metrics import roc_auc_score
    X, y = make_synthetic_binary(n=4000, f=11, seed=7)
    got, want = world.booster("int8"), jax_exchange["int8"]
    assert got._models[0].split_feature[0] \
        == want._models[0].split_feature[0]
    assert got._models[0].threshold[0] == want._models[0].threshold[0]
    assert abs(roc_auc_score(y, got.predict(X))
               - roc_auc_score(y, want.predict(X))) < 0.002

"""Crash recovery, the non-finite guard and the OOM ladder of the port
(lightgbm_tpu_torch: resilience/checkpoint.py, resilience/faults.py,
models/gbdt.py's guard and ladder, engine.py's resume, Booster.refit's
policies) held against the JAX package on the CPU.

The same numpy inputs go through both packages. Guarded, laddered and
refitted trees equal the JAX package's (structure exactly, leaf values
to rtol=1e-4, atol=1e-5) and so do their fault events (kind, iteration,
action, detail); the JAX side trains with ``hist_method="scatter"`` and
a valid set (its eager path, which resolves the guard at the exact
iteration), and the port takes XLA's float root totals
(``tests/test_torch_objectives.py`` says why). Resume is held port
against port: train 14 equals train 7 plus a resume to 14, byte for byte,
under every source of randomness the port draws. Each package reads the
other's snapshots; the port resumes from a JAX snapshot of a run that
draws nothing from its generators and refuses one of a run that does.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import cli as jax_cli
from lightgbm_tpu.resilience import FaultPlan as JaxFaultPlan
from lightgbm_tpu.resilience import checkpoint as jax_checkpoint
from lightgbm_tpu.resilience import list_snapshots as jax_list_snapshots
from lightgbm_tpu.resilience import load_snapshot as jax_load_snapshot
from lightgbm_tpu_torch import cli as port_cli
from lightgbm_tpu_torch.basic import LightGBMError
from lightgbm_tpu_torch.ops import grow
from lightgbm_tpu_torch.resilience import (CheckpointError, FaultPlan,
                                           checkpoint, list_snapshots,
                                           load_latest_snapshot,
                                           load_snapshot)
from lightgbm_tpu_torch.resilience import faults as port_faults

REPO = Path(__file__).resolve().parent.parent
CPU = {"device_type": "cpu"}
JAX = {"hist_method": "scatter"}
ENV = ("LIGHTGBM_TPU_FAULT_INJECT", "LIGHTGBM_TPU_CHECKPOINT",
       "LIGHTGBM_TPU_CHECKPOINT_EVERY", "LIGHTGBM_TPU_TELEMETRY")


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
    """Drop the JAX programs this module compiled when it ends, so that
    they do not count against the process-wide jit signature budgets
    that later tests on the same worker check."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No resilience variable leaks in or out, and the port's
    process-level fault log starts and ends empty (both packages keep
    one in this process)."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    port_faults.drain_events(port_faults.FAULT_EVENTS)
    yield
    port_faults.drain_events(port_faults.FAULT_EVENTS)


@jax.jit
def _xla_totals(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


def _jax_root_totals(full):
    v = torch.from_numpy(np.array(_xla_totals(full.numpy())))
    return v[0], v[1]


@pytest.fixture
def jax_root_totals(monkeypatch):
    monkeypatch.setattr(grow, "root_totals", _jax_root_totals)


def _same_trees(ja_models, tb_models):
    assert len(ja_models) == len(tb_models)
    for a, b in zip(ja_models, tb_models):
        assert a.num_leaves == b.num_leaves
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child", "leaf_count",
                     "internal_count"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


def _events(log):
    return [(e["kind"], e["iteration"], e["action"], e["detail"])
            for e in log]


def _binary(n=500, f=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    return X, (X[:, 0] + 0.3 * rs.randn(n) > 0).astype(float)


def _regression(n=600, f=8, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    return X, X @ rs.randn(f) + 0.1 * rs.randn(n)


GUARD = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "min_data_in_leaf": 5}
QUANT = {"use_quantized_grad": True, "stochastic_rounding": False}


def _jax_run(params, X, y, rounds, **kw):
    return jlgb.train({**params, **JAX}, jlgb.Dataset(X, label=y), rounds,
                      valid_sets=[jlgb.Dataset(X[:50], label=y[:50])], **kw)


def _port_run(params, X, y, rounds, **kw):
    return tlgb.train({**params, **CPU},
                      tlgb.Dataset(X, label=y, params=CPU), rounds,
                      valid_sets=[tlgb.Dataset(X[:50], label=y[:50],
                                               params=CPU)], **kw)


# ---- the non-finite guard ----------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["float", "quant"])
@pytest.mark.parametrize("policy", ["raise", "skip_tree", "clamp"])
@pytest.mark.parametrize("kind", ["nan_grad", "nan_hess"])
def test_guard_matches_jax(kind, policy, quant, monkeypatch,
                           jax_root_totals):
    """Each policy on poisoned gradients or hessians at iteration 1:
    the same exception and message (raise), or the same trees (the
    iteration's tree demoted to a constant, or grown from clamped
    values) and the same fault events, and training goes on."""
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", f"{kind}@1")
    X, y = _binary()
    p = {**GUARD, "nonfinite_policy": policy, **(QUANT if quant else {})}
    if policy == "raise":
        with pytest.raises(jlgb.basic.LightGBMError) as je:
            _jax_run(p, X, y, 3)
        with pytest.raises(LightGBMError) as te:
            _port_run(p, X, y, 3)
        assert str(te.value) == str(je.value)
        assert "at iteration 1" in str(te.value)
        return
    ja = _jax_run(p, X, y, 3)
    tb = _port_run(p, X, y, 3)
    assert tb.current_iteration() == 3
    assert [t.num_leaves for t in tb._models][1] == 1
    _same_trees(ja._models, tb._models)
    assert _events(tb._engine.fault_log) == _events(ja._engine.fault_log)
    assert np.all(np.isfinite(tb.predict(X[:50])))


def test_guard_without_valid_sets_keeps_the_iteration_count(monkeypatch,
                                                            tmp_path):
    """skip_tree with a checkpoint callback every iteration: the demoted
    tree does not end training (the port resolves the guard inside the
    iteration, so there is nothing for the callback to drain)."""
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "nan_grad@2")
    X, y = _binary()
    bst = tlgb.train({**GUARD, "nonfinite_policy": "skip_tree", **CPU},
                     tlgb.Dataset(X, label=y, params=CPU), 6,
                     callbacks=[checkpoint(str(tmp_path / "ck"))])
    assert bst.current_iteration() == 6
    assert [t.num_leaves for t in bst._models].count(1) == 1


def test_poisoned_iteration_never_becomes_a_snapshot(tmp_path,
                                                     monkeypatch):
    """raise x checkpoint: the newest snapshot is the last clean
    iteration, and a resume without the fault trains on from it."""
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "nan_grad@3")
    ck = str(tmp_path / "ck")
    X, y = _binary()
    p = {**GUARD, **CPU}
    with pytest.raises(LightGBMError, match="non-finite"):
        tlgb.train(p, tlgb.Dataset(X, label=y, params=CPU), 8,
                   callbacks=[checkpoint(ck, keep=10)])
    snap = load_latest_snapshot(ck)
    assert snap is not None and snap["iteration"] == 3
    assert np.all(np.isfinite(snap["score"]))
    monkeypatch.delenv("LIGHTGBM_TPU_FAULT_INJECT")
    resumed = tlgb.train(p, tlgb.Dataset(X, label=y, params=CPU), 8,
                         resume_from=ck)
    assert resumed.current_iteration() == 8
    assert all(t.num_leaves > 1 for t in resumed._models[3:])


@pytest.mark.parametrize("policy", ["raise", "skip_tree", "clamp"])
def test_refit_policies_match_jax(policy, monkeypatch, tmp_path):
    """``refit_nan@1`` poisons tree 1's gradients during refit: raise
    raises, skip_tree keeps the tree's leaf values and clamp rewrites
    the fit, with the JAX package's leaf values and fault events."""
    X, y = _binary()
    path = tmp_path / "m.txt"
    _jax_run(GUARD, X, y, 3).save_model(str(path))
    rs = np.random.RandomState(2)
    X2 = X + 0.1 * rs.randn(*X.shape)
    jm = jlgb.Booster(model_file=str(path),
                      params={"nonfinite_policy": policy})
    tm = tlgb.Booster(model_file=str(path),
                      params={"nonfinite_policy": policy, **CPU})
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "refit_nan@1")
    if policy == "raise":
        with pytest.raises(jlgb.basic.LightGBMError) as je:
            jm.refit(X2, y)
        with pytest.raises(LightGBMError) as te:
            tm.refit(X2, y)
        assert str(te.value) == str(je.value)
        return
    ja = jm.refit(X2, y)
    tb = tm.refit(X2, y)
    for a, b in zip(ja._models, tb._models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-6,
                                   atol=1e-9)
    assert _events(tb._refit_fault_log) == _events(ja._refit_fault_log)
    assert len(tb._refit_fault_log) == 1


# ---- the fault plan ----------------------------------------------------

@pytest.mark.parametrize("spec", ["", "nan_grad@7, oom@3,oom@3,kill@12",
                                  "nan_hess@0,refit_nan@2,oom@1"])
def test_fault_plan_parses_like_jax(spec):
    mine, ref = FaultPlan(spec), JaxFaultPlan(spec)
    assert mine.active == ref.active
    for kind in ("nan_grad", "nan_hess", "oom", "kill", "refit_nan"):
        assert mine.iters(kind) == ref.iters(kind)
        for it in range(13):
            assert mine.fires(kind, it) == ref.fires(kind, it)
    for it in (3, 3, 3, 1):
        assert mine.take("oom", it) == ref.take("oom", it)


@pytest.mark.parametrize("spec,error", [("explode@3", "unknown"),
                                        ("nan_grad:3", "kind@iteration")])
def test_fault_plan_rejects_like_jax(spec, error):
    with pytest.raises(ValueError, match=error):
        JaxFaultPlan(spec)
    with pytest.raises(ValueError, match=error):
        FaultPlan(spec)


# ---- the OOM ladder ----------------------------------------------------

def test_oom_rung_matches_jax(monkeypatch, jax_root_totals):
    """``oom@1``: one pool halving with the JAX package's action and
    detail, and the JAX run's trees."""
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "oom@1")
    X, y = _binary()
    ja = _jax_run(GUARD, X, y, 3)
    tb = _port_run(GUARD, X, y, 3)
    assert _events(tb._engine.fault_log) == _events(ja._engine.fault_log)
    assert _events(tb._engine.fault_log) == [
        ("oom", 1, "histogram pool -> 3 slots",
         "RESOURCE_EXHAUSTED in grow; retrying after downgrade")]
    assert tb._engine.grower.cfg.pool_slots == 3
    _same_trees(ja._models, tb._models)


def test_oom_ladder_steps_down_to_two_slots(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "oom@0,oom@0")
    X, y = _binary()
    ja = _jax_run({**GUARD, "num_leaves": 8}, X, y, 2)
    tb = _port_run({**GUARD, "num_leaves": 8}, X, y, 2)
    assert ja._engine.grow_cfg.hist_pool_slots == 2
    assert tb._engine.grower.cfg.pool_slots == 2
    assert [e[2] for e in _events(tb._engine.fault_log)] == [
        "histogram pool -> 4 slots", "histogram pool -> 2 slots"]


def test_oom_with_no_rung_left_raises_like_jax(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT",
                       "oom@0,oom@0,oom@0,oom@0")
    X, y = _binary()
    with pytest.raises(jlgb.basic.LightGBMError) as je:
        _jax_run({**GUARD, "num_leaves": 4}, X, y, 2)
    with pytest.raises(LightGBMError) as te:
        _port_run({**GUARD, "num_leaves": 4}, X, y, 2)
    assert str(te.value) == str(je.value)
    assert "no degradation left" in str(te.value)


def test_a_real_out_of_memory_error_climbs_the_ladder(monkeypatch):
    """A ``torch.OutOfMemoryError`` raised inside the grow (the caching
    allocator's) takes the same rung as the injected fault, and the run
    equals one without it."""
    X, y = _binary()
    p = {**GUARD, **CPU}
    want = tlgb.train(p, tlgb.Dataset(X, label=y, params=CPU), 3)
    real_grow = grow.Grower.grow
    calls = {"n": 0}

    def failing_grow(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 2.00 GiB")
        return real_grow(self, *args, **kwargs)
    monkeypatch.setattr(grow.Grower, "grow", failing_grow)
    got = tlgb.train(p, tlgb.Dataset(X, label=y, params=CPU), 3)
    assert got._engine.grower.cfg.pool_slots == 3
    assert _events(got._engine.fault_log)[0][:3] == (
        "oom", 1, "histogram pool -> 3 slots")
    assert got.model_to_string() == want.model_to_string()


def test_oom_retry_draws_the_same_stochastic_rounding(monkeypatch):
    """Quantized, stochastically rounded: the retry restores the rounding
    generator, so ``oom@1`` gives the trees of the run without it (a
    pool does not change quantized trees)."""
    X, y = _binary()
    p = {**GUARD, **CPU, "use_quantized_grad": True,
         "stochastic_rounding": True, "seed": 5}
    want = tlgb.train(p, tlgb.Dataset(X, label=y, params=CPU), 3)
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "oom@1")
    got = tlgb.train(p, tlgb.Dataset(X, label=y, params=CPU), 3)
    assert got._engine.grower.cfg.pool_slots == 3
    assert got.model_to_string() == want.model_to_string()


# ---- checkpoint and resume, port against port --------------------------

# bagging + the per-tree column RNG (the JAX test's _PARAMS)
BASE = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
        "min_data_in_leaf": 5, "bagging_fraction": 0.7, "bagging_freq": 2,
        "feature_fraction": 0.8, "seed": 3}
RESUME_CASES = {
    "bagging": BASE,
    "goss": {"objective": "regression", "num_leaves": 7, "verbosity": -1,
             "min_data_in_leaf": 5, "data_sample_strategy": "goss",
             "learning_rate": 0.5},
    "bynode": {"objective": "regression", "num_leaves": 7, "verbosity": -1,
               "min_data_in_leaf": 5, "feature_fraction_bynode": 0.5},
    "quantized": {"objective": "binary", "num_leaves": 7, "verbosity": -1,
                  "min_data_in_leaf": 5, "use_quantized_grad": True,
                  "stochastic_rounding": True, "seed": 7},
    "dart": {"objective": "regression", "num_leaves": 7, "verbosity": -1,
             "min_data_in_leaf": 5, "boosting": "dart", "drop_rate": 0.3,
             "skip_drop": 0.2},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "num_leaves": 5, "verbosity": -1, "min_data_in_leaf": 5,
                   "bagging_fraction": 0.8, "bagging_freq": 3},
    "lambdarank": {"objective": "lambdarank", "num_leaves": 5,
                   "verbosity": -1, "min_data_in_leaf": 5},
}


def _resume_data(name):
    X, y = _regression()
    kw = {}
    if name in ("quantized",):
        y = (y > 0).astype(float)
    elif name == "multiclass":
        y = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(float)
    elif name == "lambdarank":
        y = np.digitize(y, np.quantile(y, [0.5, 0.8, 0.95])).astype(float)
        kw["group"] = [20] * 30
    return X, y, kw


def _tds(X, y, **kw):
    return tlgb.Dataset(X, label=y, params=CPU, **kw)


@pytest.mark.parametrize("name", sorted(RESUME_CASES))
def test_resume_is_byte_identical(name, tmp_path):
    """train 14 == train 7, then a resume to 14: model strings equal byte
    for byte, with the generators' states and the cached bag restored."""
    X, y, kw = _resume_data(name)
    p = {**RESUME_CASES[name], **CPU}
    full = tlgb.train(p, _tds(X, y, **kw), 14)
    ck = str(tmp_path / "ck")
    tlgb.train(p, _tds(X, y, **kw), 7, callbacks=[checkpoint(ck)])
    resumed = tlgb.train(p, _tds(X, y, **kw), 14, resume_from=ck)
    assert resumed.current_iteration() == 14
    assert resumed.model_to_string() == full.model_to_string()


P = {**BASE, **CPU}


def test_resume_when_the_target_is_already_reached(tmp_path):
    X, y = _regression()
    ck = str(tmp_path / "ck")
    tlgb.train(P, _tds(X, y), 6, callbacks=[checkpoint(ck)])
    assert tlgb.train(P, _tds(X, y), 6,
                      resume_from=ck).current_iteration() == 6


def test_resume_from_an_empty_directory_trains_from_scratch(tmp_path):
    X, y = _regression()
    bst = tlgb.train(P, _tds(X, y), 4, resume_from=str(tmp_path / "none"))
    assert bst.current_iteration() == 4


def test_checkpoint_retention_and_final_snapshot(tmp_path):
    ck = tmp_path / "ck"
    X, y = _regression()
    tlgb.train(P, _tds(X, y), 9,
               callbacks=[checkpoint(str(ck), every_n_iters=2, keep=3)])
    names = sorted(p.name for p in ck.iterdir())
    assert names == ["ckpt_00000006.npz", "ckpt_00000008.npz",
                     "ckpt_00000009.npz"]
    for n in names:
        load_snapshot(str(ck / n))


def test_a_corrupt_newest_snapshot_falls_back_to_the_previous(tmp_path):
    ck = tmp_path / "ck"
    X, y = _regression()
    full = tlgb.train(P, _tds(X, y), 8)
    tlgb.train(P, _tds(X, y), 6, callbacks=[checkpoint(str(ck), keep=10)])
    latest = ck / "ckpt_00000006.npz"
    blob = latest.read_bytes()
    latest.write_bytes(blob[: len(blob) // 3])
    snap = load_latest_snapshot(str(ck))
    assert snap is not None and snap["iteration"] == 5
    with pytest.raises(CheckpointError):
        load_snapshot(str(latest))
    resumed = tlgb.train(P, _tds(X, y), 8, resume_from=str(ck))
    assert resumed.model_to_string() == full.model_to_string()


def test_the_env_var_installs_the_callback_and_resumes(tmp_path,
                                                       monkeypatch):
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("LIGHTGBM_TPU_CHECKPOINT", ck)
    monkeypatch.setenv("LIGHTGBM_TPU_CHECKPOINT_EVERY", "2")
    X, y = _regression()
    tlgb.train(P, _tds(X, y), 5)
    assert [r["iteration"] for r in list_snapshots(ck)] == [2, 4, 5]
    resumed = tlgb.train(P, _tds(X, y), 9)
    assert resumed.current_iteration() == 9
    monkeypatch.delenv("LIGHTGBM_TPU_CHECKPOINT")
    assert resumed.model_to_string() == \
        tlgb.train(P, _tds(X, y), 9).model_to_string()


@pytest.mark.parametrize("other", ["rows", "labels"])
def test_another_datasets_snapshot_is_refused(other, tmp_path):
    ck = str(tmp_path / "ck")
    X, y = _regression()
    tlgb.train(P, _tds(X, y), 3, callbacks=[checkpoint(ck)])
    X2, y2 = (_regression(n=300) if other == "rows" else (X, -y))
    with pytest.raises(LightGBMError, match="different training data"):
        tlgb.train(P, _tds(X2, y2), 5, resume_from=ck)


def test_resume_across_a_natural_growth_stall(tmp_path):
    """Constant labels grow nothing at iteration 0: the snapshot records
    the stall, and the resumed run stops where the uninterrupted one
    did instead of growing another constant tree."""
    rs = np.random.RandomState(5)
    X = rs.randn(300, 6)
    y = np.ones(300)
    p = {"objective": "regression", "verbosity": -1,
         "feature_fraction": 0.8, "seed": 1, **CPU}
    full = tlgb.train(p, _tds(X, y), 10)
    assert full.current_iteration() == 1
    ck = str(tmp_path / "ck")
    tlgb.train(p, _tds(X, y), 10, callbacks=[checkpoint(ck)])
    assert load_latest_snapshot(ck)["stalled"] is True
    resumed = tlgb.train(p, _tds(X, y), 10, resume_from=ck)
    assert resumed.current_iteration() == 1
    assert resumed.model_to_string() == full.model_to_string()


def test_resume_keeps_the_init_model_offset(tmp_path):
    """A run that continues an init_model of 3 iterations by 6 and is
    resumed from iteration 5 ends at 9, as the uninterrupted one."""
    X, y = _regression()
    p = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
         "min_data_in_leaf": 5, "feature_fraction": 0.8, **CPU}
    base = tlgb.train(p, _tds(X, y), 3)
    full = tlgb.train(p, _tds(X, y), 6, init_model=base)
    ck = str(tmp_path / "ck")
    tlgb.train(p, _tds(X, y), 2, init_model=base,
               callbacks=[checkpoint(ck)])
    assert load_latest_snapshot(ck)["num_init_iteration"] == 3
    resumed = tlgb.train(p, _tds(X, y), 6, init_model=base,
                         resume_from=ck)
    assert resumed.current_iteration() == 9
    assert resumed.model_to_string() == full.model_to_string()


def test_save_model_is_atomic(tmp_path, monkeypatch):
    """A crash before the rename leaves the previous model file whole
    and no temporary file behind."""
    X, y = _regression(n=300)
    bst = tlgb.train({"objective": "regression", "verbosity": -1, **CPU},
                     _tds(X, y), 2)
    out = tmp_path / "model.txt"
    bst.save_model(str(out))
    original = out.read_text()
    import lightgbm_tpu_torch.utils.atomic as atomic_mod

    def boom(src, dst):
        raise OSError("simulated crash before publish")
    monkeypatch.setattr(atomic_mod.os, "replace", boom)
    with pytest.raises(OSError, match="simulated crash"):
        bst.save_model(str(out))
    monkeypatch.undo()
    assert out.read_text() == original
    assert [p.name for p in tmp_path.iterdir()] == ["model.txt"]


_WORKER = """
import sys
import numpy as np
import lightgbm_tpu_torch as lgb
rs = np.random.RandomState(0)
X = rs.randn(600, 8)
y = X @ rs.randn(8) + 0.1 * rs.randn(600)
p = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
     "min_data_in_leaf": 5, "bagging_fraction": 0.7, "bagging_freq": 2,
     "feature_fraction": 0.8, "seed": 3, "device_type": "cpu"}
bst = lgb.train(p, lgb.Dataset(X, label=y, params={"device_type": "cpu"}),
                8)
bst.save_model(sys.argv[1])
"""


def test_sigkill_at_iteration_3_then_resume_is_byte_identical(tmp_path):
    """A worker with ``LIGHTGBM_TPU_CHECKPOINT`` and ``kill@3`` dies by
    SIGKILL at the start of iteration 3, leaving only whole snapshots;
    the resume in this process saves the uninterrupted model's text."""
    ck = str(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(PYTHONPATH=str(REPO), LIGHTGBM_TPU_CHECKPOINT=ck,
               LIGHTGBM_TPU_FAULT_INJECT="kill@3")
    out = tmp_path / "killed.txt"
    proc = subprocess.run([sys.executable, "-c", _WORKER, str(out)],
                          env=env, capture_output=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert not out.exists()
    rows = list_snapshots(ck)
    assert [r["iteration"] for r in rows] == [1, 2, 3]
    assert all(r["status"] == "ok" for r in rows)
    X, y = _regression()
    resumed = tlgb.train(P, _tds(X, y), 8, resume_from=ck)
    assert resumed.model_to_string() == \
        tlgb.train(P, _tds(X, y), 8).model_to_string()


# ---- across the packages -----------------------------------------------

# a binary run with bagging and column sampling, on _binary()'s data
BAGGED = {**GUARD, "bagging_fraction": 0.7, "bagging_freq": 2,
          "feature_fraction": 0.8, "seed": 3}


@pytest.fixture(scope="module")
def jax_snapshots(tmp_path_factory):
    """A JAX run's snapshot directory (BAGGED, 3 iterations)."""
    d = str(tmp_path_factory.mktemp("jax_ck"))
    X, y = _binary()
    _jax_run(BAGGED, X, y, 3, callbacks=[jax_checkpoint(d)])
    return d


def test_each_package_reads_the_others_snapshots(jax_snapshots, tmp_path):
    X, y = _binary()
    td = str(tmp_path / "port")
    _port_run(BAGGED, X, y, 3, callbacks=[checkpoint(td)])
    for lister, loader in ((list_snapshots, load_snapshot),
                           (jax_list_snapshots, jax_load_snapshot)):
        for d in (jax_snapshots, td):
            rows = lister(d)
            assert [r["iteration"] for r in rows] == [1, 2, 3]
            assert all(r["status"] == "ok" for r in rows)
            snap = loader(rows[-1]["path"])
            assert snap["num_trees"] == 3 and snap["score"].shape == (1, 500)
    # both packages fingerprint the same data alike
    assert load_snapshot(rows[-1]["path"])["data_fingerprint"] == \
        jax_load_snapshot(list_snapshots(jax_snapshots)[-1]["path"])[
            "data_fingerprint"]


def test_the_checkpoints_subcommand_prints_the_same_rows(tmp_path,
                                                        capsys):
    ck = tmp_path / "ck"
    X, y = _regression(n=300)
    tlgb.train(P, _tds(X, y), 4, callbacks=[checkpoint(str(ck), keep=10)])
    bad = ck / "ckpt_00000004.npz"
    bad.write_bytes(bad.read_bytes()[:64])
    assert port_cli.main(["checkpoints", str(ck)]) == 0
    mine = capsys.readouterr().out
    assert jax_cli.main(["checkpoints", str(ck)]) == 0
    assert capsys.readouterr().out == mine
    assert "corrupt" in mine and "resume target: iteration 3" in mine
    assert port_cli.main(["checkpoints", str(tmp_path / "missing")]) == 1


def test_the_port_resumes_a_jax_snapshot(tmp_path, jax_root_totals):
    """A JAX run that draws nothing from the port's generators (binary,
    feature_fraction 0.8): the port's resume from its snapshot grows the
    trees of the JAX package's own resume."""
    X, y = _binary()
    p = {**GUARD, "feature_fraction": 0.8}
    ck = str(tmp_path / "ck")
    _jax_run(p, X, y, 3, callbacks=[jax_checkpoint(ck)])
    ja = _jax_run(p, X, y, 6, resume_from=ck)
    tb = _port_run(p, X, y, 6, resume_from=ck)
    assert tb.current_iteration() == 6
    _same_trees(ja._models[3:], tb._models[3:])


def test_a_jax_snapshot_of_a_bagging_run_is_refused(jax_snapshots):
    X, y = _binary()
    with pytest.raises(LightGBMError, match="gen_bag"):
        _port_run(BAGGED, X, y, 6, resume_from=jax_snapshots)

"""Batch prediction from raw features.

Counterpart of ``predict_any`` and ``convert_raw_scores`` in
``lightgbm_tpu/prediction.py``, for forests of numerical and categorical
splits with constant or linear leaves: the forest is stacked into device tensors
(a categorical split's u32 bitset over category values padded to the
forest's widest, ``[T, N, W]``), every row
walks every tree (:func:`ops.predict.predict_leaf_raw`) in float32 —
thresholds rounded down to float32 so that a float32 feature keeps its
training-time side, as in the JAX package — a linear leaf gives its
model on the row's raw values (its constant for a row with NaN in one of
its features; :func:`ops.linear.linear_leaf_values`), a constant tree in
a forest that has linear ones a model of no feature — tree ``i`` adds to class
``i % K`` (K trees per iteration), and the raw scores are converted by
the objective named in the model: a sigmoid for binary and
cross_entropy, a softmax with the row max subtracted for multiclass, a
sigmoid per class for multiclassova, ``exp`` for poisson, gamma and
tweedie, ``log1p(exp)`` for cross_entropy_lambda, none for the other
regressions and ranking. A random forest's model
(``average_output``) predicts the mean of its iterations' raw scores
over the iterations used, before the transform. Scores are ``[n]`` for
K = 1, else ``[n, K]``; ``num_iteration`` counts iterations (K trees
each).

``pred_early_stop`` (prediction_early_stop.cpp, the JAX
``_predict_scores_early_stop``) walks the forest in chunks of ``freq *
K`` trees and freezes a row once its margin passes ``margin``: ``2 |s|``
for one score, the gap between the two largest for K > 1; once every row
is frozen the walk stops (one read-back per chunk). It is on only for
the objectives that tolerate inexact sums (binary, multiclass and
ranking) and never for averaged outputs (random forest).
``pred_contrib`` gives TreeSHAP contributions (:mod:`shap`, float64 on
the device) as ``[n, (F + 1) * K]``. After ``Booster.compile()`` a
prediction over the compiled iteration range (not early-stopping, not
``pred_leaf``) walks the compiled forest (``serve/compile.py``) instead
of stacking the trees again; the answers are the same bit for bit.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .models.tree import Tree
from .ops.linear import linear_leaf_values
from .ops.predict import StackedTrees, predict_leaf_raw

__all__ = ["predict_any", "stack_trees", "convert_raw_scores",
           "forest_scores"]


def _tree_depth(t: Tree) -> int:
    if t.num_nodes == 0:
        return 1
    depth = np.zeros(t.num_nodes, np.int64)
    out = 1
    for i in range(t.num_nodes):          # parents precede children
        for c in (t.left_child[i], t.right_child[i]):
            if c >= 0:
                depth[c] = depth[i] + 1
            else:
                out = max(out, int(depth[i]) + 1)
    return out


def stack_trees(trees: List[Tree], device) -> StackedTrees:
    """Stack a forest into ``[T, ...]`` device tensors."""
    T = len(trees)
    N = max(1, max((t.num_nodes for t in trees), default=1))
    Lm = max((t.num_leaves for t in trees), default=1)
    sf = np.zeros((T, N), np.int64)
    thr = np.zeros((T, N), np.float64)
    dl = np.zeros((T, N), bool)
    mt = np.zeros((T, N), np.int64)
    lc = np.full((T, N), -1, np.int64)
    rc = np.full((T, N), -1, np.int64)
    lv = np.zeros((T, Lm), np.float64)
    any_cat = any(t.num_cat > 0 for t in trees)
    W = max((int(np.diff(t.cat_boundaries).max()) for t in trees
             if t.num_cat > 0), default=1)
    ic = np.zeros((T, N), bool)
    bits = np.zeros((T, N, W), np.int64)
    for i, t in enumerate(trees):
        nn = t.num_nodes
        if nn > 0:
            sf[i, :nn] = t.split_feature
            ic[i, :nn] = (t.decision_type & 1) != 0
            thr[i, :nn] = np.where(ic[i, :nn], 0.0, t.threshold)
            for node in np.nonzero(ic[i, :nn])[0]:
                k = int(t.threshold[node])
                a, b = t.cat_boundaries[k], t.cat_boundaries[k + 1]
                bits[i, node, :b - a] = t.cat_threshold[a:b]
            dl[i, :nn] = (t.decision_type & 2) != 0
            mt[i, :nn] = (t.decision_type >> 2) & 3
            lc[i, :nn] = t.left_child
            rc[i, :nn] = t.right_child
        lv[i, :t.num_leaves] = t.leaf_value
    # f32-safe thresholds: round DOWN to the nearest f32
    thr32 = thr.astype(np.float32)
    bad = thr32.astype(np.float64) > thr
    thr32[bad] = np.nextafter(thr32[bad], np.float32(-np.inf))

    def dev(a):
        return torch.as_tensor(a, device=device)

    lin = {}
    if any(t.is_linear and t.leaf_const is not None for t in trees):
        km = max(1, max((len(fs) for t in trees if t.leaf_features
                         for fs in t.leaf_features), default=0))
        lconst = np.zeros((T, Lm), np.float64)
        lnf = np.zeros((T, Lm), np.int64)
        lfe = np.zeros((T, Lm, km), np.int64)
        lco = np.zeros((T, Lm, km), np.float64)
        for i, t in enumerate(trees):
            if t.is_linear and t.leaf_const is not None:
                lconst[i, :t.num_leaves] = t.leaf_const[:t.num_leaves]
                for leaf in range(t.num_leaves):
                    fs = t.leaf_features[leaf] if t.leaf_features else []
                    lnf[i, leaf] = len(fs)
                    lfe[i, leaf, :len(fs)] = fs
                    lco[i, leaf, :len(fs)] = t.leaf_coeff[leaf]
            else:
                # a constant tree in a linear forest: a model of no
                # feature
                lconst[i, :t.num_leaves] = t.leaf_value
        lin = dict(lin_const=dev(lconst.astype(np.float32)),
                   lin_nfeat=dev(lnf), lin_feats=dev(lfe),
                   lin_coef=dev(lco.astype(np.float32)))

    return StackedTrees(
        split_feature=dev(sf), threshold=dev(thr32), default_left=dev(dl),
        missing_type=dev(mt), left_child=dev(lc), right_child=dev(rc),
        leaf_value=dev(lv.astype(np.float32)),
        depth=max((_tree_depth(t) for t in trees), default=1),
        is_categorical=dev(ic) if any_cat else None,
        cat_bitset=dev(bits) if any_cat else None, **lin)


def tree_outputs(stacked: StackedTrees, X: torch.Tensor,
                 leaves: torch.Tensor) -> torch.Tensor:
    """``[T, n]`` float32 output of every tree on every row, given the
    rows' ``[T, n]`` leaves: the leaf value, or a linear leaf's model."""
    if stacked.lin_const is None:
        return stacked.leaf_value.gather(1, leaves)
    return torch.stack([linear_leaf_values(
        stacked.lin_const[i], stacked.lin_coef[i], stacked.lin_feats[i],
        stacked.lin_nfeat[i], stacked.leaf_value[i], X, leaves[i])
        for i in range(leaves.shape[0])])


def forest_scores(stacked: StackedTrees, X: torch.Tensor,
                  K: int) -> torch.Tensor:
    """``[K, n]`` float32 raw scores of raw rows ``X``: tree ``i`` adds
    to class ``i % K``, one tree after the other, the order in which
    training adds them to a valid set's float32 score."""
    vals = tree_outputs(stacked, X, predict_leaf_raw(stacked, X))
    scores = torch.zeros((K, X.shape[0]), dtype=vals.dtype,
                         device=X.device)
    for i in range(vals.shape[0]):
        scores[i % K] += vals[i]
    return scores


def _matrix(data, pandas_categorical) -> np.ndarray:
    """A float64 matrix of the rows to predict: a pandas frame's
    category columns become their codes (over the training frame's
    categories when the model has them; NaN for a missing or unknown
    value), as the JAX package's ``_extract_matrix`` does."""
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(data, pd.DataFrame):
        arrs, ci = [], 0
        for col in data.columns:
            s = data[col]
            if isinstance(s.dtype, pd.CategoricalDtype):
                if pandas_categorical is not None \
                        and ci < len(pandas_categorical):
                    s = s.cat.set_categories(pandas_categorical[ci])
                ci += 1
                codes = s.cat.codes.to_numpy().astype(np.float64)
                codes[codes < 0] = np.nan
                arrs.append(codes)
            else:
                arrs.append(s.to_numpy(dtype=np.float64, na_value=np.nan))
        return np.column_stack(arrs) if arrs \
            else np.zeros((len(data), 0))
    if hasattr(data, "toarray"):
        return np.asarray(data.todense(), np.float64)
    return np.asarray(data, dtype=np.float64)


def predict_any(booster, data, start_iteration: int = 0,
                num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0) -> np.ndarray:
    from .basic import Dataset, LightGBMError
    if isinstance(data, Dataset):
        raise LightGBMError(
            "Cannot use Dataset instance for prediction, please use raw "
            "data instead")
    X = _matrix(data, booster.pandas_categorical)
    if X.ndim == 1:
        X = X[None, :]
    n_feat = booster.num_feature()
    if n_feat and X.shape[1] != n_feat:
        raise LightGBMError(
            f"The number of features in data ({X.shape[1]}) is not the "
            f"same as it was in training data ({n_feat}).")
    trees = booster._models
    K = booster.num_model_per_iteration()
    total_iters = len(trees) // max(K, 1)
    if num_iteration is None or num_iteration <= 0:
        num_iteration = total_iters - start_iteration
    num_iteration = min(num_iteration, total_iters - start_iteration)
    sel = trees[start_iteration * K:(start_iteration + num_iteration) * K]
    n = X.shape[0]
    if pred_contrib:
        if any(t.is_linear and t.leaf_coeff
               and any(len(c) for c in t.leaf_coeff) for t in sel):
            raise LightGBMError(
                "pred_contrib (SHAP) is not supported for linear trees")
        from .shap import predict_contrib
        return predict_contrib(booster, X, sel, K)
    if not sel:
        out = np.zeros((n, K), np.float64)
        return out[:, 0] if K == 1 else out
    obj_name = (booster._objective_str or "none").split()[0]
    use_es = pred_early_stop and not pred_leaf \
        and not booster._avg_output and obj_name in (
            "binary", "multiclass", "multiclassova", "softmax",
            "lambdarank", "rank_xendcg")
    cf = getattr(booster, "_compiled_forest", None)
    lo, hi = start_iteration * K, (start_iteration + num_iteration) * K
    if cf is not None and not use_es and not pred_leaf \
            and cf.matches(lo, hi, len(trees)):
        # the compiled forest (serve/compile.py): stacked on the device
        # once, rows padded to its power-of-two buckets
        out = cf.predict_raw(X)
    else:
        device = booster._device
        stacked = stack_trees(sel, device)
        Xd = torch.as_tensor(X, dtype=torch.float32, device=device)
        if pred_leaf:
            return predict_leaf_raw(stacked, Xd).T.to(
                torch.int32).cpu().numpy()
        if use_es:
            scores = _scores_early_stop(stacked, Xd, K,
                                        max(1, pred_early_stop_freq),
                                        pred_early_stop_margin)
        else:
            scores = forest_scores(stacked, Xd, K)
        out = scores.T.cpu().numpy().astype(np.float64)
    if booster._avg_output:
        # random forest: the trees are stored unscaled; average over the
        # iterations actually used
        out = out / max(1, num_iteration)
    if not raw_score:
        out = convert_raw_scores(booster._objective_str, out)
    return out[:, 0] if K == 1 else out


def _scores_early_stop(stacked: StackedTrees, X: torch.Tensor, K: int,
                       freq: int, margin: float) -> torch.Tensor:
    """``[K, n]`` float32 scores of the forest walked in chunks of ``freq
    * K`` trees, each row frozen once its margin passes ``margin``. Trees
    add one after the other, so a walk that freezes no row gives the
    full walk's scores bit for bit."""
    T = stacked.leaf_value.shape[0]
    n = X.shape[0]
    scores = torch.zeros((K, n), dtype=torch.float32, device=X.device)
    done = torch.zeros(n, dtype=torch.bool, device=X.device)
    chunk = freq * K
    for lo in range(0, T, chunk):
        hi = min(T, lo + chunk)
        sub = StackedTrees(*(v[lo:hi] if isinstance(v, torch.Tensor) else v
                             for v in stacked))
        vals = tree_outputs(sub, X, predict_leaf_raw(sub, X))
        for i in range(hi - lo):
            scores[(lo + i) % K] += torch.where(done, 0.0, vals[i])
        if K == 1:
            m = 2.0 * scores[0].abs()
        else:
            top2 = torch.topk(scores, 2, dim=0).values
            m = top2[0] - top2[1]
        done = done | (m > margin)
        if bool(done.all()):
            break
    return scores


def convert_raw_scores(objective_str: Optional[str],
                       out: np.ndarray) -> np.ndarray:
    """Objective-specific output transform, driven by the objective
    string of the model header."""
    obj = (objective_str or "none").split()
    name = obj[0] if obj else "none"
    kv = dict(t.split(":", 1) for t in obj[1:] if ":" in t)
    flags = {t for t in obj[1:] if ":" not in t}
    if name == "binary":
        sig = float(kv.get("sigmoid", 1.0))
        return 1.0 / (1.0 + np.exp(-sig * out))
    if name in ("multiclass", "softmax"):
        e = np.exp(out - out.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)
    if name == "multiclassova":
        sig = float(kv.get("sigmoid", 1.0))
        return 1.0 / (1.0 + np.exp(-sig * out))
    if name in ("poisson", "gamma", "tweedie"):
        return np.exp(out)
    if name == "cross_entropy":
        return 1.0 / (1.0 + np.exp(-out))
    if name == "cross_entropy_lambda":
        return np.log1p(np.exp(out))
    if name in ("regression", "regression_l2") and "sqrt" in flags:
        return np.sign(out) * out * out
    return out

"""Model text serialization.

A copy of ``model_to_string`` and ``load_model_string`` of
``lightgbm_tpu/models/model_io.py``: the same LightGBM-compatible
layout (``tree`` header, ``Tree=i`` blocks, ``end of trees``, feature
importances, ``parameters:``, ``pandas_categorical``), so a model saved
by either package loads in the other. A model has K = ``num_class``
trees per iteration (``num_tree_per_iteration``), tree ``i`` in class
``i % K``. ``dump_model_dict`` (the JSON dump of ``Booster.dump_model``)
and ``trees_to_dataframe`` (pandas, imported when called) are copies of
the JAX package's too. The ``parameters:`` block lists
the port's own :class:`~lightgbm_tpu_torch.config.Config` fields; no
loader reads it.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from .tree import Tree

__all__ = ["model_to_string", "load_model_string", "dump_model_dict",
           "trees_to_dataframe"]


def model_to_string(booster, num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    importance_type: str = "split") -> str:
    K = booster.num_model_per_iteration()
    trees = booster._models
    total_iters = len(trees) // max(K, 1)
    if num_iteration is None or num_iteration <= 0:
        num_iteration = total_iters - start_iteration
    lo = start_iteration * K
    hi = min(len(trees), (start_iteration + num_iteration) * K)
    sel = trees[lo:hi]

    nf = booster.num_feature()
    feature_names = booster._feature_names or \
        [f"Column_{i}" for i in range(nf)]
    feature_infos = booster._feature_infos or ["none"] * nf

    out = ["tree", "version=v4"]
    out.append(f"num_class={max(1, booster._num_class)}")
    out.append(f"num_tree_per_iteration={K}")
    out.append("label_index=0")
    out.append(f"max_feature_idx={nf - 1}")
    out.append(f"objective={booster._objective_str}")
    if booster._avg_output:
        out.append("average_output")
    out.append("feature_names=" + " ".join(feature_names))
    out.append("feature_infos=" + " ".join(feature_infos))

    tree_strs = [t.to_string(i) for i, t in enumerate(sel)]
    out.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
    out.append("")
    out.extend(s.rstrip("\n") + "\n" for s in tree_strs)
    out.append("end of trees")
    out.append("")

    imp = booster.feature_importance(importance_type)
    pairs = [(feature_names[i], imp[i]) for i in np.argsort(-np.asarray(imp))
             if imp[i] > 0]
    out.append("feature_importances:")
    for name, v in pairs:
        out.append(f"{name}={v:g}" if importance_type == "gain"
                   else f"{name}={int(v)}")
    out.append("")
    out.append("parameters:")
    if booster._cfg is not None:
        out.append(booster._cfg.to_string())
    out.append("end of parameters")
    out.append("")
    pc = booster.pandas_categorical
    out.append("pandas_categorical:" +
               json.dumps(pc) if pc is not None else
               "pandas_categorical:null")
    return "\n".join(out) + "\n"


def load_model_string(booster, s: str) -> None:
    """Populate a Booster from model text (LoadModelFromString analog)."""
    lines = s.split("\n")
    header: Dict[str, str] = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            break
        if "=" in line:
            k, v = line.split("=", 1)
            header[k] = v
        elif line == "average_output":
            header["average_output"] = "1"
        i += 1

    trees: List[Tree] = []
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            kv: Dict[str, str] = {}
            i += 1
            while i < len(lines):
                tl = lines[i].strip()
                if tl == "" or tl.startswith("Tree=") or \
                        tl.startswith("end of trees"):
                    break
                if "=" in tl:
                    k, v = tl.split("=", 1)
                    kv[k] = v
                i += 1
            trees.append(Tree.from_lines(kv))
        elif line.startswith("end of trees"):
            break
        else:
            i += 1

    num_class = int(header.get("num_class", "1"))
    K = int(header.get("num_tree_per_iteration", max(1, num_class)))
    if K != max(1, num_class) or len(trees) % K:
        raise ValueError(
            f"model text with num_class={num_class}, "
            f"num_tree_per_iteration={K} and {len(trees)} trees: the port "
            "reads K = num_class trees per iteration, tree i in class i % K")
    booster._trees = trees
    booster._num_class = num_class
    booster._objective_str = header.get("objective", "none")
    booster._avg_output = "average_output" in header
    booster._feature_names = header.get("feature_names", "").split()
    booster._feature_infos = header.get("feature_infos", "").split()
    pc_line = next((ln for ln in reversed(lines)
                    if ln.startswith("pandas_categorical:")), None)
    if pc_line is not None:
        try:
            booster.pandas_categorical = json.loads(
                pc_line.split(":", 1)[1])
        except json.JSONDecodeError:
            booster.pandas_categorical = None


def _node_to_dict(t: Tree, node: int) -> Dict:
    if node < 0:
        leaf = ~node
        return {
            "leaf_index": int(leaf),
            "leaf_value": float(t.leaf_value[leaf]),
            "leaf_weight": float(t.leaf_weight[leaf]),
            "leaf_count": int(t.leaf_count[leaf]),
        }
    d = {
        "split_index": int(node),
        "split_feature": int(t.split_feature[node]),
        "split_gain": float(t.split_gain[node]),
        "threshold": float(t.threshold[node]),
        "decision_type": "==" if t.is_categorical_node(node) else "<=",
        "default_left": t.default_left(node),
        "missing_type": ["None", "Zero", "NaN"][t.missing_type(node)],
        "internal_value": float(t.internal_value[node]),
        "internal_weight": float(t.internal_weight[node]),
        "internal_count": int(t.internal_count[node]),
        "left_child": _node_to_dict(t, t.left_child[node]),
        "right_child": _node_to_dict(t, t.right_child[node]),
    }
    return d


def dump_model_dict(booster, num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    importance_type: str = "split") -> Dict:
    """JSON model dump (GBDT::DumpModel analog, boosting.h:182)."""
    K = booster.num_model_per_iteration()
    trees = booster._models
    total_iters = len(trees) // max(K, 1)
    if num_iteration is None or num_iteration <= 0:
        num_iteration = total_iters - start_iteration
    lo = start_iteration * K
    hi = min(len(trees), (start_iteration + num_iteration) * K)
    nf = booster.num_feature()
    return {
        "name": "tree",
        "version": "v4",
        "num_class": max(1, booster._num_class),
        "num_tree_per_iteration": K,
        "label_index": 0,
        "max_feature_idx": nf - 1,
        "objective": booster._objective_str,
        "average_output": booster._avg_output,
        "feature_names": booster._feature_names,
        "feature_infos": booster._feature_infos,
        "tree_info": [
            {
                "tree_index": i,
                "num_leaves": int(t.num_leaves),
                "num_cat": int(t.num_cat),
                "shrinkage": float(t.shrinkage),
                "tree_structure": _node_to_dict(
                    t, 0 if t.num_leaves > 1 else -1),
            }
            for i, t in enumerate(trees[lo:hi])
        ],
        "feature_importances": {
            booster._feature_names[i] if i < len(booster._feature_names)
            else f"Column_{i}": float(v)
            for i, v in enumerate(booster.feature_importance(importance_type))
            if v > 0
        },
    }


def trees_to_dataframe(booster):
    """Flatten the forest into a pandas DataFrame
    (basic.py trees_to_dataframe analog)."""
    import pandas as pd
    rows = []
    fnames = booster._feature_names

    for ti, t in enumerate(booster._models):
        def walk(node, parent_idx=None, depth=0):
            if node < 0:
                leaf = ~node
                rows.append({
                    "tree_index": ti,
                    "node_depth": depth + 1,
                    "node_index": f"{ti}-L{leaf}",
                    "left_child": None, "right_child": None,
                    "parent_index": parent_idx,
                    "split_feature": None, "split_gain": None,
                    "threshold": None, "decision_type": None,
                    "missing_direction": None, "missing_type": None,
                    "value": float(t.leaf_value[leaf]),
                    "weight": float(t.leaf_weight[leaf]),
                    "count": int(t.leaf_count[leaf]),
                })
                return
            idx = f"{ti}-S{node}"
            f = int(t.split_feature[node])
            rows.append({
                "tree_index": ti,
                "node_depth": depth + 1,
                "node_index": idx,
                "left_child": (f"{ti}-S{t.left_child[node]}"
                               if t.left_child[node] >= 0
                               else f"{ti}-L{~t.left_child[node]}"),
                "right_child": (f"{ti}-S{t.right_child[node]}"
                                if t.right_child[node] >= 0
                                else f"{ti}-L{~t.right_child[node]}"),
                "parent_index": parent_idx,
                "split_feature": fnames[f] if f < len(fnames) else str(f),
                "split_gain": float(t.split_gain[node]),
                "threshold": float(t.threshold[node]),
                "decision_type": "==" if t.is_categorical_node(node)
                else "<=",
                "missing_direction": "left" if t.default_left(node)
                else "right",
                "missing_type": ["None", "Zero", "NaN"][t.missing_type(node)],
                "value": float(t.internal_value[node]),
                "weight": float(t.internal_weight[node]),
                "count": int(t.internal_count[node]),
            })
            walk(t.left_child[node], idx, depth + 1)
            walk(t.right_child[node], idx, depth + 1)

        walk(0 if t.num_leaves > 1 else -1)
    return pd.DataFrame(rows)

"""Model text serialization.

A copy of ``model_to_string`` and ``load_model_string`` of
``lightgbm_tpu/models/model_io.py``: the same LightGBM-compatible
layout (``tree`` header, ``Tree=i`` blocks, ``end of trees``, feature
importances, ``parameters:``, ``pandas_categorical``), so a model saved
by either package loads in the other. The ``parameters:`` block lists
the port's own :class:`~lightgbm_tpu_torch.config.Config` fields; no
loader reads it.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from .tree import Tree

__all__ = ["model_to_string", "load_model_string"]


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

    booster._trees = trees
    booster._num_class = int(header.get("num_class", "1"))
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

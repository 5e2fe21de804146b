"""Carry state of the JAX package into the port.

The JAX package's objects are handed over as numpy arrays and plain
lists (``np.asarray(...)`` of its fields), so this module imports
neither ``jax`` nor ``lightgbm_tpu``:

- :func:`mappers_from_fields` — ``BinMapper`` fields (the ``to_dict``
  form, or the attributes as a dict) to the port's mappers, so the port
  bins with the reference's mappers;
- :func:`tree_arrays_from_fields` — a grown tree's ``TreeArrays`` fields
  (categorical splits' ``split_is_cat`` and ``split_cat_mask`` included)
  to the port's host ``TreeArrays``;
- :func:`tree_from_fields` — a host ``Tree``'s fields to the port's
  ``Tree``;
- :func:`booster_from_fields` / :func:`booster_fields` — a whole model
  (its trees, K trees per iteration with tree ``i`` in class ``i % K``,
  the objective string, the feature header, ``average_output``, the
  random-forest flag, and ``pandas_categorical``) into a port ``Booster``
  and back out as plain fields, from which the JAX package's ``Tree``
  objects are built as ``Tree(**fields)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np

from .models.tree import Tree
from .ops.binning import BinMapper
from .ops.grow import TreeArrays

__all__ = ["mappers_from_fields", "tree_arrays_from_fields",
           "tree_from_fields", "booster_from_fields", "booster_fields",
           "TREE_ARRAY_FIELDS"]

TREE_ARRAY_FIELDS = TreeArrays._fields

_MAPPER_FIELDS = [f.name for f in dataclasses.fields(BinMapper)]


def mappers_from_fields(fields: Sequence[Mapping[str, Any]]
                        ) -> List[BinMapper]:
    """One port ``BinMapper`` per field dict (``BinMapper.to_dict()`` or
    ``vars(mapper)`` of the JAX package)."""
    out = []
    for d in fields:
        d = dict(d)
        if d.get("cat_to_bin") is None and d.get("bin_to_cat") is not None:
            d["cat_to_bin"] = {int(c): i for i, c in
                               enumerate(d["bin_to_cat"])}
        kw = {k: d[k] for k in _MAPPER_FIELDS if k in d}
        if kw.get("upper_bounds") is not None:
            kw["upper_bounds"] = np.asarray(kw["upper_bounds"], np.float64)
        if kw.get("bin_to_cat") is not None:
            kw["bin_to_cat"] = np.asarray(kw["bin_to_cat"], np.int64)
        out.append(BinMapper(**kw))
    return out


def tree_arrays_from_fields(fields: Mapping[str, Any]) -> TreeArrays:
    """The port's ``TreeArrays`` from the JAX ``TreeArrays`` fields."""
    kw: Dict[str, Any] = {}
    for name in TREE_ARRAY_FIELDS:
        v = fields[name]
        kw[name] = int(np.asarray(v)) if name == "num_leaves" \
            else np.asarray(v)
    return TreeArrays(**kw)


def tree_from_fields(fields: Mapping[str, Any]) -> Tree:
    """The port's ``Tree`` from a host ``Tree``'s fields
    (``dataclasses.asdict`` or ``vars`` of the JAX object)."""
    names = [f.name for f in dataclasses.fields(Tree)]
    kw = {}
    for k in names:
        if k not in fields:
            continue
        v = fields[k]
        kw[k] = np.asarray(v) if isinstance(v, (np.ndarray, list)) \
            and k not in ("leaf_features", "leaf_coeff") else v
    return Tree(**kw)


def booster_from_fields(model: Mapping[str, Any], params=None):
    """A port ``Booster`` holding a model given as plain fields:
    ``trees`` (one field dict per tree, as :func:`tree_from_fields`
    takes), ``num_class`` (K; the trees of iteration ``it`` are
    ``trees[it * K:(it + 1) * K]``), ``objective`` (the model text's
    objective string, e.g. ``"multiclass num_class:3"`` or
    ``"lambdarank"``), ``feature_names``, ``feature_infos`` and, for a
    random forest, ``average_output=True`` (predictions are the mean of
    the iterations' outputs). ``params`` picks the device
    (``device_type``) it predicts on."""
    from .basic import Booster, resolve_device
    from .config import Config
    trees = [tree_from_fields(t) for t in model["trees"]]
    K = max(1, int(model["num_class"]))
    if len(trees) % K:
        raise ValueError(f"{len(trees)} trees are not whole iterations of "
                         f"{K} trees")
    bst = Booster.__new__(Booster)
    bst._blank(params)
    bst._device = resolve_device(Config.from_params(params))
    bst._trees = trees
    bst._num_class = K
    bst._objective_str = str(model["objective"])
    bst._feature_names = list(model["feature_names"])
    bst._feature_infos = list(model["feature_infos"])
    bst._avg_output = bool(model.get("average_output", False))
    bst.pandas_categorical = model.get("pandas_categorical")
    return bst


def booster_fields(booster) -> Dict[str, Any]:
    """A port ``Booster``'s model as plain fields (the form
    :func:`booster_from_fields` takes), each tree as a dict of numpy
    arrays and plain values."""
    return dict(
        trees=[{f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
               for t in booster._models],
        num_class=max(1, booster._num_class),
        num_tree_per_iteration=booster.num_model_per_iteration(),
        objective=booster._objective_str,
        feature_names=list(booster._feature_names),
        feature_infos=list(booster._feature_infos),
        average_output=bool(booster._avg_output),
        pandas_categorical=booster.pandas_categorical)

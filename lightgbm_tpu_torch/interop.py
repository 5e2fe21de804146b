"""Carry state of the JAX package into the port.

The JAX package's objects are handed over as numpy arrays and plain
lists (``np.asarray(...)`` of its fields), so this module imports
neither ``jax`` nor ``lightgbm_tpu``:

- :func:`mappers_from_fields` — ``BinMapper`` fields (the ``to_dict``
  form, or the attributes as a dict) to the port's mappers, so the port
  bins with the reference's mappers;
- :func:`tree_arrays_from_fields` — a grown tree's ``TreeArrays`` fields
  to the port's host ``TreeArrays``;
- :func:`tree_from_fields` — a host ``Tree``'s fields to the port's
  ``Tree``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np

from .models.tree import Tree
from .ops.binning import BinMapper
from .ops.grow import TreeArrays

__all__ = ["mappers_from_fields", "tree_arrays_from_fields",
           "tree_from_fields", "TREE_ARRAY_FIELDS"]

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
    """The port's ``TreeArrays`` from the JAX ``TreeArrays`` fields
    (numerical splits: the categorical fields must be all False)."""
    if np.any(np.asarray(fields.get("split_is_cat", False))):
        raise NotImplementedError(
            "categorical splits are not in the port yet (ROADMAP.md "
            "Queue 1 item 13)")
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

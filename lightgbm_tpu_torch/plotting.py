"""Plotting of the port's models.

A copy of ``lightgbm_tpu/plotting.py`` over the port's ``Booster`` and
``Tree``: ``plot_importance``, ``plot_split_value_histogram``,
``plot_metric``, ``create_tree_digraph`` and ``plot_tree``, with the
same signatures and the same bars, curves and digraph source.
matplotlib and graphviz are imported when a function is called, never
with the module; without graphviz the tree functions raise.
"""

from __future__ import annotations

from copy import deepcopy
from typing import List, Optional, Tuple

import numpy as np

from .basic import Booster

__all__ = ["plot_importance", "plot_split_value_histogram", "plot_metric",
           "plot_tree", "create_tree_digraph"]


def _pair(value, name: str) -> Tuple:
    """Validate a 2-tuple plot bound (figsize / xlim / ylim)."""
    if not isinstance(value, tuple) or len(value) != 2:
        raise TypeError(f"{name} must be a tuple of 2 elements.")
    return value


def _new_axes(ax, figsize, dpi):
    if ax is not None:
        return ax
    import matplotlib.pyplot as plt
    if figsize is not None:
        _pair(figsize, "figsize")
    _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    return ax


def _decorate_axes(ax, *, xlim=None, ylim=None, title=None, xlabel=None,
                   ylabel=None, grid=True) -> None:
    """Apply the common bound/label/grid decoration in one place."""
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)


def _to_booster(booster) -> Booster:
    if isinstance(booster, Booster):
        return booster
    if hasattr(booster, "booster_"):
        return booster.booster_
    raise TypeError("booster must be Booster or fitted LGBMModel.")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[Tuple] = None,
                    ylim: Optional[Tuple] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "auto",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: Optional[int] = 3,
                    **kwargs):
    """Horizontal bar plot of feature importances."""
    bst = _to_booster(booster)
    if importance_type == "auto":
        importance_type = getattr(booster, "importance_type", "split")
    importance = bst.feature_importance(importance_type=importance_type)
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")

    ranked = sorted(zip(bst.feature_name(), importance),
                    key=lambda pair: pair[1])
    if ignore_zero:
        ranked = [pair for pair in ranked if pair[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        ranked = ranked[-max_num_features:]
    labels = [pair[0] for pair in ranked]
    values = [pair[1] for pair in ranked]

    ax = _new_axes(ax, figsize, dpi)
    positions = np.arange(len(values))
    ax.barh(positions, values, align="center", height=height, **kwargs)
    fmt = (f"{{:.{precision}f}}"
           if importance_type == "gain" and precision is not None
           else "{}")
    for pos, val in zip(positions, values):
        ax.text(val + 1, pos, fmt.format(val), va="center")
    ax.set_yticks(positions)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _pair(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1 if values else 1)
    if ylim is not None:
        _pair(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    _decorate_axes(ax, xlim=xlim, ylim=ylim, title=title, xlabel=xlabel,
                   ylabel=ylabel, grid=grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8,
                               xlim: Optional[Tuple] = None,
                               ylim: Optional[Tuple] = None,
                               title: Optional[str] = "Split value histogram "
                               "for feature with @index/name@ @feature@",
                               xlabel: Optional[str] = "Feature split value",
                               ylabel: Optional[str] = "Count",
                               figsize=None, dpi=None, grid: bool = True,
                               **kwargs):
    """Histogram of one feature's split thresholds across the model."""
    bst = _to_booster(booster)
    if isinstance(feature, str):
        fidx = bst.feature_name().index(feature)
    else:
        fidx = int(feature)
    thresholds = [
        tree.threshold[node]
        for tree in bst._models
        for node in range(tree.num_nodes)
        if tree.split_feature[node] == fidx
        and not tree.is_categorical_node(node)]
    if not thresholds:
        raise ValueError(
            "Cannot plot split value histogram, "
            f"because feature {feature} was not used in splitting")
    counts, edges = np.histogram(thresholds, bins=bins or "auto")
    centers = (edges[:-1] + edges[1:]) / 2.0

    ax = _new_axes(ax, figsize, dpi)
    ax.bar(centers, counts, width=width_coef * np.diff(edges),
           align="center", **kwargs)
    if xlim is not None:
        _pair(xlim, "xlim")
    if ylim is not None:
        _pair(ylim, "ylim")
    else:
        ylim = (0, max(counts) * 1.1)
    if title is not None:
        kind = "name" if isinstance(feature, str) else "index"
        title = title.replace("@feature@", str(feature)) \
                     .replace("@index/name@", kind)
    _decorate_axes(ax, xlim=xlim, ylim=ylim, title=title, xlabel=xlabel,
                   ylabel=ylabel, grid=grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim: Optional[Tuple] = None, ylim: Optional[Tuple] = None,
                title: Optional[str] = "Metric during training",
                xlabel: Optional[str] = "Iterations",
                ylabel: Optional[str] = "@metric@", figsize=None, dpi=None,
                grid: bool = True):
    """Plot metric curves from a record_evaluation dict or fitted sklearn
    estimator."""
    if isinstance(booster, dict):
        history = deepcopy(booster)
    elif hasattr(booster, "evals_result_"):
        history = deepcopy(booster.evals_result_)
    else:
        raise TypeError(
            "booster must be dict (from record_evaluation) or LGBMModel")
    if not history:
        raise ValueError("eval results cannot be empty.")

    names = list(history.keys()) if dataset_names is None \
        else [n for n in dataset_names if n in history]
    if not names:
        raise ValueError("eval results cannot be empty.")

    first_metrics = history[names[0]]
    if metric is None:
        if len(first_metrics) > 1:
            raise ValueError(
                "more than one metric available, pick one with the "
                "'metric' parameter")
        metric = next(iter(first_metrics))
    elif metric not in first_metrics:
        raise ValueError("No given metric in eval results.")

    ax = _new_axes(ax, figsize, dpi)
    lo, hi, length = float("inf"), float("-inf"), 0
    for name in names:
        curve = history[name][metric]
        ax.plot(range(len(curve)), curve, label=name)
        lo = min(lo, min(curve))
        hi = max(hi, max(curve))
        length = max(length, len(curve))
    ax.legend(loc="best")

    if xlim is not None:
        _pair(xlim, "xlim")
    else:
        xlim = (0, length)
    if ylim is not None:
        _pair(ylim, "ylim")
    else:
        pad = 0.05 * (hi - lo + 1e-12)
        ylim = (lo - pad, hi + pad)
    if ylabel is not None:
        ylabel = ylabel.replace("@metric@", metric)
    _decorate_axes(ax, xlim=xlim, ylim=ylim, title=title, xlabel=xlabel,
                   ylabel=ylabel, grid=grid)
    return ax


def _node_text(tree, node: int, is_leaf: bool, show_info: List[str],
               precision: int, feature_names: List[str]) -> str:
    """Multi-line node label for the digraph."""
    if is_leaf:
        lines = [f"leaf {node}",
                 f"value: {tree.leaf_value[node]:.{precision}f}"]
        if "leaf_count" in show_info:
            lines.append(f"count: {int(tree.leaf_count[node])}")
        if "leaf_weight" in show_info:
            lines.append(f"weight: {tree.leaf_weight[node]:.{precision}f}")
        return "\n".join(lines)
    f = tree.split_feature[node]
    fname = feature_names[f] if f < len(feature_names) else f"f{f}"
    if tree.is_categorical_node(node):
        lines = [f"{fname} in categories"]
    else:
        lines = [f"{fname} <= {tree.threshold[node]:.{precision}f}"]
    if "split_gain" in show_info:
        lines.append(f"gain: {tree.split_gain[node]:.{precision}f}")
    if "internal_value" in show_info:
        lines.append(f"value: {tree.internal_value[node]:.{precision}f}")
    if "internal_count" in show_info:
        lines.append(f"count: {int(tree.internal_count[node])}")
    return "\n".join(lines)


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: Optional[int] = 3,
                        orientation: str = "horizontal", **kwargs):
    """Build a graphviz Digraph of one tree."""
    try:
        from graphviz import Digraph
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "You must install graphviz and restart your session to "
            "plot tree.") from e

    bst = _to_booster(booster)
    if tree_index < 0 or tree_index >= len(bst._models):
        raise IndexError("tree_index is out of range.")
    tree = bst._models[tree_index]
    feature_names = bst.feature_name()
    show_info = show_info or []
    precision = 3 if precision is None else precision

    graph = Digraph(**kwargs)
    graph.attr("graph", nodesep="0.05", ranksep="0.3",
               rankdir="LR" if orientation == "horizontal" else "TB")

    def add(node: int, parent: Optional[str]) -> None:
        if node < 0:  # leaf
            leaf = ~node
            name = f"leaf{leaf}"
            graph.node(name, _node_text(tree, leaf, True, show_info,
                                        precision, feature_names))
        else:
            name = f"split{node}"
            graph.node(name, _node_text(tree, node, False, show_info,
                                        precision, feature_names))
            add(int(tree.left_child[node]), name)
            add(int(tree.right_child[node]), name)
        if parent is not None:
            graph.edge(parent, name)

    if tree.num_leaves <= 1:
        graph.node("leaf0", _node_text(tree, 0, True, show_info,
                                       precision, feature_names))
    else:
        add(0, None)
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None, dpi=None,
              show_info=None, precision: Optional[int] = 3,
              orientation: str = "horizontal", **kwargs):
    """Render one tree with matplotlib via graphviz."""
    import matplotlib.image as mpimg
    from io import BytesIO

    ax = _new_axes(ax, figsize, dpi)
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    img = mpimg.imread(BytesIO(graph.pipe(format="png")))
    ax.imshow(img)
    ax.axis("off")
    return ax

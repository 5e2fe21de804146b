"""A model as standalone C++ if-else code (``task=convert_model``).

A copy of ``lightgbm_tpu/convert.py`` (LightGBM's ``SaveModelToIfElse``)
over the port's ``Tree``: one ``PredictTree<i>`` function per tree, a
``PredictRaw`` that sums them by class and a ``Predict`` that applies
the objective's output transform. The text equals the JAX package's for
the same model, so a model converted by either compiles the same. A
numerical split compares ``fval <= threshold`` after missing values are
routed (``missing_type`` nan: NaN goes the default way; zero: NaN and
values within 1e-35 of 0 do; none: NaN is 0), a categorical split tests
``int(fval)``'s bit in the split's u32 words.
"""

from __future__ import annotations

from typing import List

__all__ = ["model_to_if_else"]

_HEADER = """\
// Generated by lightgbm_tpu task=convert_model. Standalone: no deps.
#include <cmath>
#include <cstring>

namespace lightgbm_tpu_model {

inline bool IsZero(double v) { return v > -1e-35 && v < 1e-35; }
"""


def _node_code(tree, node: int, lines: List[str], indent: str) -> None:
    f = int(tree.split_feature[node])
    mt = tree.missing_type(node)
    dl = tree.default_left(node)
    if tree.is_categorical_node(node):
        cat_idx = int(tree.threshold[node])
        lo = int(tree.cat_boundaries[cat_idx])
        hi = int(tree.cat_boundaries[cat_idx + 1])
        words = ", ".join(f"0x{int(w) & 0xFFFFFFFF:08x}u"
                          for w in tree.cat_threshold[lo:hi])
        lines.append(f"{indent}static const unsigned int "
                     f"bitset_{node}[] = {{{words}}};")
        cond = (f"!std::isnan(fval[{f}]) && fval[{f}] >= 0 && "
                f"(int)fval[{f}] / 32 < {hi - lo} && "
                f"((bitset_{node}[(int)fval[{f}] / 32] >> "
                f"((int)fval[{f}] % 32)) & 1)")
    else:
        thr = repr(float(tree.threshold[node]))
        v = f"fval[{f}]"
        if mt != 2:
            # missing_type none/zero folds NaN into 0.0 before the
            # comparison (Tree::NumericalDecisionIfElse, tree.cpp)
            v = f"(std::isnan({v}) ? 0.0 : {v})"
        if mt == 2:  # NaN
            miss = f"std::isnan({v})"
        elif mt == 1:  # zero
            miss = f"IsZero({v})"
        else:
            miss = None
        base = f"{v} <= {thr}"
        if miss is None:
            cond = base
        elif dl:
            cond = f"{miss} || ({base})"
        else:
            cond = f"!({miss}) && ({base})"
    lines.append(f"{indent}if ({cond}) {{")
    _child_code(tree, int(tree.left_child[node]), lines, indent + "  ")
    lines.append(f"{indent}}} else {{")
    _child_code(tree, int(tree.right_child[node]), lines, indent + "  ")
    lines.append(f"{indent}}}")


def _child_code(tree, child: int, lines: List[str], indent: str) -> None:
    if child < 0:
        leaf = ~child
        lines.append(
            f"{indent}return {float(tree.leaf_value[leaf])!r};")
    else:
        _node_code(tree, child, lines, indent)


def model_to_if_else(booster) -> str:
    """Emit C++ with PredictTreeN functions + Predict/PredictRaw."""
    trees = booster._models
    K = booster.num_model_per_iteration()
    obj_str = getattr(booster, "_objective_str", "") or ""
    obj = obj_str.split(" ")[0] if obj_str else ""
    sqrt_reg = obj in ("regression", "regression_l2") and " sqrt" in obj_str
    sigmoid = 1.0
    for tok in obj_str.split(" ")[1:]:
        if tok.startswith("sigmoid:"):
            sigmoid = float(tok.split(":", 1)[1])
    lines = [_HEADER]
    for i, t in enumerate(trees):
        lines.append(f"double PredictTree{i}(const double* fval) {{")
        if t.num_leaves <= 1:
            lines.append(f"  return {float(t.leaf_value[0])!r};")
        else:
            body: List[str] = []
            _node_code(t, 0, body, "  ")
            lines.extend(body)
        lines.append("}")
        lines.append("")
    lines.append(f"const int kNumTrees = {len(trees)};")
    lines.append(f"const int kNumModelPerIter = {K};")
    lines.append("""
typedef double (*TreeFn)(const double*);
static const TreeFn kTrees[] = {""")
    for i in range(len(trees)):
        lines.append(f"  PredictTree{i},")
    lines.append("};")
    lines.append("""
// Raw (margin) scores: out must hold kNumModelPerIter doubles.
void PredictRaw(const double* fval, double* out) {
  for (int k = 0; k < kNumModelPerIter; ++k) out[k] = 0.0;
  for (int i = 0; i < kNumTrees; ++i)
    out[i % kNumModelPerIter] += kTrees[i](fval);
}
""")
    if obj == "binary":
        lines.append(f"""
void Predict(const double* fval, double* out) {{
  PredictRaw(fval, out);
  out[0] = 1.0 / (1.0 + std::exp(-{sigmoid!r} * out[0]));
}}
""")
    elif obj in ("multiclass",):
        lines.append("""
void Predict(const double* fval, double* out) {
  PredictRaw(fval, out);
  double m = out[0];
  for (int k = 1; k < kNumModelPerIter; ++k) if (out[k] > m) m = out[k];
  double s = 0.0;
  for (int k = 0; k < kNumModelPerIter; ++k) { out[k] = std::exp(out[k] - m); s += out[k]; }
  for (int k = 0; k < kNumModelPerIter; ++k) out[k] /= s;
}
""")
    elif obj in ("multiclassova", "cross_entropy", "xentropy"):
        lines.append(f"""
void Predict(const double* fval, double* out) {{
  PredictRaw(fval, out);
  for (int k = 0; k < kNumModelPerIter; ++k)
    out[k] = 1.0 / (1.0 + std::exp(-{sigmoid!r} * out[k]));
}}
""")
    elif obj in ("cross_entropy_lambda", "xentlambda"):
        lines.append("""
void Predict(const double* fval, double* out) {
  PredictRaw(fval, out);
  out[0] = std::log1p(std::exp(out[0]));
}
""")
    elif obj in ("poisson", "gamma", "tweedie"):
        lines.append("""
void Predict(const double* fval, double* out) {
  PredictRaw(fval, out);
  out[0] = std::exp(out[0]);
}
""")
    elif sqrt_reg:
        lines.append("""
void Predict(const double* fval, double* out) {
  PredictRaw(fval, out);
  out[0] = (out[0] < 0 ? -1.0 : 1.0) * out[0] * out[0];
}
""")
    else:
        lines.append("""
void Predict(const double* fval, double* out) { PredictRaw(fval, out); }
""")
    lines.append("}  // namespace lightgbm_tpu_model")
    return "\n".join(lines)

"""The int8 histogram wire's accuracy on the rows of ``chip_smoke.py``'s
1M-row worlds, by the JAX package: its mesh at ``num_devices=2`` on the
exchange strategy (the one the port's worlds run), f32 and int8, on the
CPU. ``chip_smoke.py`` holds the port's int8 world on the card to this
reading (``DIST_INT8_JAX_AUC``), since the JAX package's int8 wire itself
falls far below f32 (ROADMAP.md Queue 3).

The rows are the smoke's: ``make_higgs_like`` of train's 10,500,000 rows
and the 500,000 held-out ones; the world trains on the first
``DIST_SMALL_ROWS`` with ``_dist_params`` (binary, 255 leaves and bins,
1 + 1 iterations) and is scored on the held-out rows.

Run from the repository's root (about 3 minutes and 6 GB on 8 cores):

    python tests/torch_int8_wire_reference.py
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") \
    + " --xla_force_host_platform_device_count=2"
os.environ["LIGHTGBM_TPU_COMM_EXCHANGE"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import lightgbm_tpu as jlgb  # noqa: E402
from sklearn.metrics import roc_auc_score  # noqa: E402

TRAIN_ROWS = 10_500_000


def main():
    X, y = cs.make_higgs_like(TRAIN_ROWS + cs.VALID_ROWS, cs.FEATURES)
    m = cs.DIST_SMALL_ROWS
    Xs, ys = X[:m].copy(), y[:m].copy()
    Xv, yv = X[TRAIN_ROWS:].copy(), y[TRAIN_ROWS:].copy()
    del X, y
    params = cs._dist_params("cpu", tree_learner="data", num_devices=2)
    params.pop("device_type")
    for hc in ("f32", "int8"):
        bst = jlgb.train({**params, "hist_comm": hc},
                         jlgb.Dataset(Xs, label=ys,
                                      params={"max_bin": cs.BINS}), 2)
        print(f"JAX mesh of 2, exchange, hist_comm={hc}: AUC "
              f"{roc_auc_score(yv, bst.predict(Xv))!r}", flush=True)


if __name__ == "__main__":
    main()

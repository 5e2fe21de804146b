"""``train``: the training entry point of the port.

Counterpart of ``train`` in ``lightgbm_tpu/engine.py`` for the main
path: ``num_boost_round`` iterations (or ``num_iterations`` from the
params), stopping early when a tree cannot grow. Valid sets, early
stopping, callbacks, init models and checkpoints are ROADMAP.md Queue 1
item 12 and later.
"""

from __future__ import annotations

from typing import Any, Dict

from .basic import Booster, Dataset
from .config import resolve_params

__all__ = ["train"]


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          feval=None, init_model=None, callbacks=None,
          **kwargs) -> Booster:
    if valid_sets or valid_names or feval is not None \
            or init_model is not None or callbacks or kwargs:
        raise NotImplementedError(
            "valid sets, feval, init_model, callbacks and the other "
            "train() options are not in the port yet (ROADMAP.md Queue 1 "
            "item 12)")
    if not isinstance(train_set, Dataset):
        raise TypeError("train() only accepts Dataset object(s)")
    params = resolve_params(params)
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    booster = Booster(params=params, train_set=train_set)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster

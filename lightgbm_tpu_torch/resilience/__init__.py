"""Crash recovery and fault injection of the port: the counterpart of
``lightgbm_tpu/resilience/`` for one training process on one card.

- :mod:`.checkpoint` — atomic periodic snapshots (model text, the
  ``[K, n]`` score, the host RNGs and the port's ``torch.Generator``
  states) with retention, and ``train(..., resume_from=dir)`` /
  ``LIGHTGBM_TPU_CHECKPOINT`` auto-resume that reproduces the
  uninterrupted model byte for byte;
- :mod:`.faults` — the ``LIGHTGBM_TPU_FAULT_INJECT`` harness
  (``nan_grad``, ``nan_hess``, ``oom``, ``kill``, ``refit_nan``) and the
  fault-event log;
- the non-finite guard (``nonfinite_policy``: raise, skip_tree, clamp)
  and the OOM ladder live in ``models/gbdt.py``.

The collective watchdog is ROADMAP.md Queue 1 item 21's rest; the
supervised restarts (``elastic.py``, ``autoscale.py``) item 20; model
publication (``publisher.py``, ``store.py``) item 19.
"""

from .checkpoint import (CHECKPOINT_MAGIC, Checkpoint, CheckpointError,
                         checkpoint, list_snapshots, load_latest_snapshot,
                         load_snapshot, restore_booster, snapshot_path,
                         write_snapshot)
from .faults import (FaultPlan, InjectedResourceExhausted,
                     is_resource_exhausted, record_fault_event)

__all__ = [
    "checkpoint", "Checkpoint", "CheckpointError", "snapshot_path",
    "write_snapshot", "load_snapshot", "load_latest_snapshot",
    "list_snapshots", "restore_booster", "CHECKPOINT_MAGIC",
    "FaultPlan", "InjectedResourceExhausted", "is_resource_exhausted",
    "record_fault_event",
]

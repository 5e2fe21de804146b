"""Crash recovery and fault injection of the port: the counterpart of
``lightgbm_tpu/resilience/`` for one training process on one card.

- :mod:`.checkpoint` — atomic periodic snapshots (model text, the
  ``[K, n]`` score, the host RNGs and the port's ``torch.Generator``
  states) with retention, and ``train(..., resume_from=dir)`` /
  ``LIGHTGBM_TPU_CHECKPOINT`` auto-resume that reproduces the
  uninterrupted model byte for byte;
- :mod:`.faults` — the ``LIGHTGBM_TPU_FAULT_INJECT`` harness
  (``nan_grad``, ``nan_hess``, ``oom``, ``kill``, ``rank_kill``,
  ``refit_nan``, and the lifecycle kinds ``publish_torn``,
  ``publish_poison``, ``store_outage``, ``serve_kill``) and the
  fault-event log;
- :mod:`.store` — the artifact-store transport (a local directory, or
  the faultable in-memory object store behind ``mem://<name>``);
- :mod:`.publisher` — manifest-first model publication (sha256, a
  canary, retries with jittered backoff, retention and rollback), the
  writer side of the serving daemon's watch target;
- :mod:`.elastic` — the supervisor of ``python -m lightgbm_tpu_torch
  launch``: a fleet of serve replicas restarted one by one, health
  checked, autoscaled and guarded against bad publications, or a
  one-rank training run restarted from its newest snapshot;
- :mod:`.autoscale` — the fleet's scaling policy and rollback guard;
- the non-finite guard (``nonfinite_policy``: raise, skip_tree, clamp)
  and the OOM ladder live in ``models/gbdt.py``.

Importing this package imports no torch (the checkpoint module imports
it where a snapshot restores generators), so the supervisors, the
serving daemon's parse path and the publisher stay torch-free. As in
the JAX package, ``elastic`` and ``autoscale`` are imported as
submodules; the package root exports none of their names.

The collective watchdog (:mod:`.watchdog`) puts a deadline around every
host collective of a world of ranks (``parallel/hostsync.py``);
``launch N`` without ``--health-port`` supervises such a world, and
``stall_rank`` / ``init_refuse`` fault it.
"""

from .checkpoint import (CHECKPOINT_MAGIC, Checkpoint, CheckpointError,
                         checkpoint, list_snapshots, load_latest_snapshot,
                         load_snapshot, restore_booster, snapshot_path,
                         write_snapshot)
from .faults import (FaultPlan, InjectedResourceExhausted,
                     is_resource_exhausted, record_fault_event)
from .publisher import (PublishError, latest_manifest, load_manifest,
                        prune_publications, publish_model,
                        rollback_publication, validate_artifact)
from .store import (ArtifactStore, LocalDirStore, MemoryBackend,
                    ObjectStore, StoreError, store_for)

__all__ = [
    "checkpoint", "Checkpoint", "CheckpointError", "snapshot_path",
    "write_snapshot", "load_snapshot", "load_latest_snapshot",
    "list_snapshots", "restore_booster", "CHECKPOINT_MAGIC",
    "FaultPlan", "InjectedResourceExhausted", "is_resource_exhausted",
    "record_fault_event",
    "ArtifactStore", "LocalDirStore", "MemoryBackend", "ObjectStore",
    "StoreError", "store_for",
    "PublishError", "publish_model", "latest_manifest", "load_manifest",
    "prune_publications", "rollback_publication", "validate_artifact",
]


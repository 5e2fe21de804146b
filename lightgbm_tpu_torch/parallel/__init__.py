"""Distributed training on ``torch.distributed`` (the JAX package's
``lightgbm_tpu/parallel/``): the world of ranks (:mod:`.mesh`), its
start (:mod:`.distributed`), host collectives under the watchdog
(:mod:`.hostsync`), the dataset protocol (:mod:`.spmd`), the histogram
collectives and the payload models (:mod:`.comms`), the grower's
distributed modes (:mod:`.data_parallel`) and the world's snapshot
(:mod:`.placement`).

A rank is one process on one device. ``python -m lightgbm_tpu_torch
launch N -- <worker>`` starts N of them; each calls
:func:`distributed.init_distributed`, builds its row shard with
:func:`spmd.distributed_dataset` and trains with
``tree_learner=data|feature|voting|auto``; every rank ends with the
same model.
"""

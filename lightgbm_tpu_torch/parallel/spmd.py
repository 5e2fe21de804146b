"""The dataset protocol and the step checks of a world (the JAX
package's ``parallel/spmd.py``).

The reference's distributed loading (``dataset_loader.cpp``
``ConstructBinMappersFromTextData``): each rank loads its row shard and
every rank bins against identical boundaries. In the port:

    from lightgbm_tpu_torch.parallel import distributed, spmd
    distributed.init_distributed()                 # Network::Init
    ds = spmd.distributed_dataset(my_X, my_y, params=...)
    bst = lgb.train(params | {"tree_learner": "data"}, ds, 100)

:func:`distributed_dataset` checks the shards' row counts and metadata
fields (named errors), broadcasts rank 0's bin mappers
(:func:`sync_bin_mappers`) and bins the rank's rows against them on the
rank's device. Unlike the JAX package, the binned rows are never
gathered: each rank keeps only its shard, and the grower reduces
histograms instead (``parallel/data_parallel.py``). Every rank trains
the same model.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

__all__ = ["sync_bin_mappers", "distributed_dataset",
           "aggregate_phase_snapshot", "verify_step_consistency"]


def _world(world):
    from .hostsync import default_world
    return world or default_world()


def verify_step_consistency(iteration: int, num_trees: int,
                            world=None) -> None:
    """Every rank must agree on the iteration and the tree count at each
    sync point; one ``[2]`` int64 allgather under the watchdog turns a
    divergence into a ``LightGBMError`` and a dead or stalled peer into
    a deadline error naming this collective (``spmd/verify_step``). A
    world of one: a no-op."""
    world = _world(world)
    if world.size <= 1:
        return
    from .hostsync import host_allgather

    local = np.asarray([int(iteration), int(num_trees)], np.int64)
    g = host_allgather(local, "spmd/verify_step", iteration=int(iteration),
                       world=world)
    if not (g == g[0]).all():
        from ..basic import LightGBMError
        detail = "; ".join(
            f"rank {r}: iteration={int(a)}, trees={int(b)}"
            for r, (a, b) in enumerate(g))
        raise LightGBMError(
            "SPMD divergence: processes disagree on the training step "
            f"({detail}). The replicated models are no longer "
            "identical — aborting instead of hanging in a collective.")


def aggregate_phase_snapshot(snap: dict, world=None) -> dict:
    """Per-label ``{"min", "max", "mean", "count"}`` of a
    ``Timer.snapshot()``'s totals across ranks (the recorder's skew
    view). Ranks run the same loop, so they hold the same labels; one
    host allgather per event. A world of one: min == max == mean."""
    world = _world(world)
    labels = sorted(snap)
    totals = np.asarray([snap[lb]["total"] for lb in labels], np.float64)
    if world.size > 1 and labels:
        from .hostsync import host_allgather
        g = host_allgather(totals, "telemetry/phase_skew", world=world)
    else:
        g = totals[None, :]
    return {lb: {"min": float(g[:, i].min()),
                 "max": float(g[:, i].max()),
                 "mean": float(g[:, i].mean()),
                 "count": int(snap[lb]["count"])}
            for i, lb in enumerate(labels)}


def sync_bin_mappers(mappers: Optional[List], world=None) -> List:
    """Rank 0's mappers on every rank: rank 0 serializes them (JSON of
    ``BinMapper.to_dict``) and broadcasts the bytes; the others pass
    anything (None)."""
    world = _world(world)
    if world.size <= 1:
        return mappers
    from ..ops.binning import BinMapper
    from .hostsync import host_broadcast_bytes

    payload = None
    if world.rank == 0:
        payload = json.dumps([m.to_dict() for m in mappers]).encode()
    buf = host_broadcast_bytes(payload, "spmd/sync_bin_mappers",
                               world=world)
    return [BinMapper.from_dict(d) for d in json.loads(buf.decode())]


def _check_shards(ds_meta: np.ndarray, world) -> np.ndarray:
    """Allgather the shards' metadata ``[rows, groups, label?, weight?,
    init_score?, position?]`` and raise naming the ranks that differ."""
    from ..basic import LightGBMError
    from .hostsync import host_allgather

    gmeta = host_allgather(ds_meta, "spmd/dataset_meta", world=world)
    n_locals = gmeta[:, 0]
    if len(set(n_locals.tolist())) > 1:
        detail = ", ".join(
            f"rank {r}: {int(n)} rows" for r, n in enumerate(n_locals))
        raise LightGBMError(
            "distributed_dataset requires equal row counts per process "
            f"(pad the last shard with weight-0 rows); got {detail}")
    for name, col in (("group", 1), ("label", 2), ("weight", 3),
                      ("init_score", 4), ("position", 5)):
        present = gmeta[:, col] >= (0 if col == 1 else 1)
        if present.any() and not present.all():
            have = [r for r in range(len(present)) if present[r]]
            miss = [r for r in range(len(present)) if not present[r]]
            raise LightGBMError(
                f"distributed_dataset: ranks {have} carry {name!r} but "
                f"ranks {miss} do not — every shard must provide the "
                "same metadata fields, or the bulk allgather "
                "deadlocks/misaligns")
    return gmeta


def _mapper_reference(full_mappers, feature_names, cat_idx, device):
    """A constructed-looking Dataset that holds only rank 0's binning
    (the ``reference`` the other ranks bin against)."""
    import torch

    from ..basic import Dataset
    from ..data.ingest import used_mappers

    ref = Dataset(None, params={})
    used, mappers = used_mappers(full_mappers)
    ref._full_mappers = full_mappers
    ref._used_features = used
    ref.mappers = mappers
    ref._feature_names = list(feature_names)
    ref._cat_idx = set(cat_idx)
    ref._F_total = len(full_mappers)
    ref._F = len(mappers)
    ref.device = device
    ref._bins = torch.empty((0, len(mappers)), dtype=torch.uint8)
    return ref


def distributed_dataset(X, label=None, params: Optional[dict] = None,
                        world=None, **kwargs):
    """This rank's training Dataset from its row shard ``X`` (numpy or
    anything ``Dataset`` takes in memory), binned against rank 0's
    mappers.

    Shards must have equal row counts (pad the last one with weight-0
    rows) and the same metadata fields; each shard holds whole query
    groups for ranking. The Dataset keeps only this shard (``_shard`` =
    ``(first global row, global rows)``); the grower reduces histograms
    across ranks (``parallel/data_parallel.py``)."""
    from ..basic import Dataset

    world = _world(world)
    ds = Dataset(X, label=label, params=params, **kwargs)
    if world.size <= 1:
        return ds.construct()
    meta = np.asarray([
        np.shape(X)[0] if hasattr(X, "shape") else len(X),
        -1 if ds.group is None else len(np.asarray(ds.group)),
        0 if ds.label is None else 1,
        0 if ds.weight is None else 1,
        0 if ds.init_score is None else 1,
        0 if ds.position is None else 1,
    ], np.int64)
    gmeta = _check_shards(meta, world)
    n_local = int(gmeta[0, 0])
    if world.rank == 0:
        ds.construct()
        names, cats = ds._feature_names, sorted(ds._cat_idx)
        mappers = ds._full_mappers
        header = json.dumps({"names": list(names), "cats": list(cats)})
    else:
        mappers, header = None, None
    mappers = sync_bin_mappers(mappers, world=world)
    from .hostsync import host_broadcast_bytes
    hdr = json.loads(host_broadcast_bytes(
        None if header is None else header.encode(),
        "spmd/dataset_header", world=world).decode())
    if world.rank != 0:
        from ..basic import resolve_device
        from ..config import Config
        dev = resolve_device(Config.from_params(params))
        ds.reference = _mapper_reference(mappers, hdr["names"],
                                         hdr["cats"], dev)
        ds.construct()
        ds.reference = None
    ds._shard = (world.rank * n_local, n_local * world.size)
    return ds

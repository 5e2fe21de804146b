"""Atomic training checkpoints and auto-resume: the counterpart of
``lightgbm_tpu/resilience/checkpoint.py``, with its file names
(``ckpt_<iteration:08d>.npz``), ``CHECKPOINT_MAGIC``, npz members and
state keys, so each package lists and loads the other's snapshots.

One snapshot is one npz file written atomically (in-memory npz ->
same-directory tmp -> ``os.replace``, ``utils/atomic.py``). It carries:

- the model text (``%.17g``; float64 leaf values round-trip exactly);
- the ``[K, n]`` float32 train score, restored verbatim (a score rebuilt
  from the trees differs in the last ulp, which would flip a split);
- the numpy ``RandomState``s of per-tree feature sampling and of DART's
  drops, by Mersenne state;
- tree weights, best score and iteration, string attributes, the train
  set's name, a parameter fingerprint (drift at resume warns) and a data
  fingerprint (n, F, K and ``data/ingest.py`` ``dataset_digest``;
  a mismatch refuses to resume);
- ``stalled`` (the last iteration grew nothing, so a resumed run stops
  where the uninterrupted one did) and ``num_init_iteration`` (the
  ``init_model`` offset of a continued run).

The port's own members: the JAX package's device streams are pure
``fold_in(key, iteration)`` functions, but the port draws bagging and
GOSS, per-node column sampling and stochastic rounding from
``torch.Generator``s whose state advances with every draw. So a port
snapshot adds ``gen_bag``, ``gen_bynode`` and ``gen_rounding`` (each
generator's ``get_state()``) and ``cached_bag`` (the bagging draw kept
between refreshes, packed to bits). A snapshot without them (the JAX
package's) resumes only a run that draws from none of those generators;
any other run raises ``LightGBMError`` naming the missing state. It also
adds ``tree_internal_value`` and ``tree_shrinkage``, the trees' internal
values and shrinkage at full precision: the model text prints them with
``%g``, and DART rescales the kept trees, so a resumed DART run needs
the unrounded values to write the uninterrupted run's text.

A world of ranks (``parallel/``): every rank joins the step check and
the gather of the row-sharded score (``placement.fetch_global``, and of
the cached bag) before rank 0 writes for all. The snapshot stores the
assembled ``[K, n]`` score, as a one-process snapshot does, plus one
sha256 per rank's rows of it (``score_shard_fingerprints``); a resumed
rank takes its own rows and checks them against its fingerprint. So a
world's snapshot resumes a one-rank run of the same data and the other
way round, and the JAX package's loader reads it (it ignores the port's
members).

``train(..., resume_from=dir)`` — or ``LIGHTGBM_TPU_CHECKPOINT=<dir>``,
which also installs the checkpoint callback — loads the newest snapshot
that validates, skipping corrupt or truncated files, and trains on from
its iteration toward the run's end iteration.
"""

from __future__ import annotations

import io
import json
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..log import log_info, log_warning
from ..utils.atomic import atomic_write_bytes

__all__ = ["checkpoint", "Checkpoint", "CheckpointError", "snapshot_path",
           "write_snapshot", "load_snapshot", "load_latest_snapshot",
           "list_snapshots", "restore_booster", "CHECKPOINT_MAGIC"]

CHECKPOINT_MAGIC = "lightgbm_tpu.checkpoint.v1"
_FILE_RE = re.compile(r"^ckpt_(\d{8})\.npz$")

#: the port's generators: npz member -> GBDTBooster attribute
_GENERATORS = {"gen_bag": "_bag_gen", "gen_bynode": "_bynode_gen",
               "gen_rounding": "_rounding_gen"}


class CheckpointError(ValueError):
    """A snapshot file failed validation (corrupt / truncated / foreign)."""


def snapshot_path(directory: str, iteration: int) -> str:
    return os.path.join(os.fspath(directory), f"ckpt_{iteration:08d}.npz")


# ---------------------------------------------------------------------
# RNG state (numpy legacy MT19937 tuple) <-> npz-storable pieces
# ---------------------------------------------------------------------

def _rng_state_arrays(rng: np.random.RandomState):
    name, keys, pos, has_gauss, cached = rng.get_state()
    meta = {"name": name, "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached)}
    return np.asarray(keys, np.uint32), meta


def _rng_restore(rng: np.random.RandomState, keys: np.ndarray,
                 meta: Dict[str, Any]) -> None:
    rng.set_state((meta["name"], np.asarray(keys, np.uint32),
                   int(meta["pos"]), int(meta["has_gauss"]),
                   float(meta["cached_gaussian"])))


# ---------------------------------------------------------------------
# write
# ---------------------------------------------------------------------

def write_snapshot(directory: str, booster, keep: int = 3,
                   score_host: Optional[np.ndarray] = None,
                   bag_host: Optional[np.ndarray] = None) -> str:
    """Snapshot ``booster`` into ``directory`` atomically; prune old
    snapshots beyond ``keep``. Returns the snapshot path. The non-finite
    guard resolves inside each iteration (``models/gbdt.py``), so a
    poisoned iteration has raised before any snapshot of it is
    written. ``score_host`` / ``bag_host``: a world's assembled score and
    cached bag (:meth:`Checkpoint.__call__` gathers them)."""
    eng = booster._engine
    if eng is None:
        raise CheckpointError(
            "cannot checkpoint a prediction-only Booster (no engine)")
    model_str = booster.model_to_string()
    iteration = int(eng.iter_)
    frng_keys, frng_meta = _rng_state_arrays(eng._feature_rng)
    drng_keys, drng_meta = _rng_state_arrays(eng._dart_rng)
    state = {
        "magic": CHECKPOINT_MAGIC,
        "iteration": iteration,
        "num_trees": len(booster._models),
        "num_model_per_iteration": int(eng.K),
        "num_init_iteration": int(eng.init_iteration),
        "best_iteration": int(booster.best_iteration),
        "best_score": {str(d): {str(m): float(v)
                                for m, v in sub.items()}
                       for d, sub in (booster.best_score or {}).items()},
        # the port keeps no per-tree weight apart from the trees: DART
        # rescales the trees themselves, as the JAX package's does
        "tree_weights": [1.0] * len(booster._models),
        "feature_rng": frng_meta,
        "dart_rng": drng_meta,
        "attrs": dict(booster._attrs),
        "train_data_name": booster._train_data_name,
        "params_fingerprint": _params_fingerprint(booster.params),
        "data_fingerprint": _dataset_fingerprint(eng),
        "stalled": bool(eng._finished_natural),
        "score_shard_fingerprints": None,
    }
    if score_host is None:
        score_host = eng.score.cpu().numpy()
    else:
        from ..parallel import placement
        state["score_shard_fingerprints"] = placement.shard_fingerprints(
            score_host, _row_bounds(eng))
    members = dict(
        state_json=np.frombuffer(json.dumps(state).encode("utf-8"),
                                 np.uint8),
        model_str=np.frombuffer(model_str.encode("utf-8"), np.uint8),
        score=np.asarray(score_host).astype(np.float32, copy=False),
        frng_keys=frng_keys,
        drng_keys=drng_keys,
    )
    for key, attr in _GENERATORS.items():
        gen = getattr(eng, attr)
        if gen is not None:
            members[key] = gen.get_state().numpy()
    models = booster._models
    members["tree_shrinkage"] = np.array([t.shrinkage for t in models],
                                         np.float64)
    members["tree_internal_value"] = np.concatenate(
        [np.asarray(t.internal_value, np.float64) for t in models]
        or [np.zeros(0)])
    if bag_host is None and eng._cached_bag is not None:
        bag_host = eng._cached_bag.cpu().numpy()
    if bag_host is not None:
        members["cached_bag"] = np.packbits(np.asarray(bag_host) > 0)
    buf = io.BytesIO()
    np.savez(buf, **members)
    path = snapshot_path(directory, iteration)
    atomic_write_bytes(path, buf.getvalue())
    _prune(os.fspath(directory), keep)
    return path


def _dataset_fingerprint(eng) -> Dict[str, Any]:
    """The identity of the training data a snapshot was written against,
    as the JAX package computes it: shape plus ``dataset_digest`` (a
    sha256 over the float64 labels and the first 64 binned rows; a
    streamed construct accumulated the same digest). Hashed once per
    engine."""
    cached = getattr(eng, "_ckpt_data_fp", None)
    if cached is not None:
        return cached
    ts = eng.train_set
    digest = getattr(ts, "_data_digest", None)
    if digest is None and getattr(ts, "_shard", None) is not None \
            and eng.comm is not None:
        # one rank's shard: rank 0 holds the world's first rows; it
        # hashes them with the world's labels and every rank joins the
        # broadcast
        from ..parallel.hostsync import host_broadcast_bytes
        payload = None
        if eng.comm.rank == 0:
            from ..data.ingest import dataset_digest
            payload = dataset_digest(
                np.asarray(eng._glabel, np.float64),
                ts._bins[:64].cpu().numpy()).encode()
        digest = host_broadcast_bytes(payload,
                                      "spmd/dataset_digest").decode()
    if digest is None:
        from ..data.ingest import dataset_digest
        digest = dataset_digest(
            np.asarray(ts.get_label(), np.float64),
            ts._bins[:64].cpu().numpy())
    fp = {"n": int(eng.n_global), "F": int(ts.num_features()),
          "K": int(eng.K), "digest": digest}
    eng._ckpt_data_fp = fp
    return fp


#: params whose drift between write and resume is expected and benign
#: (the JAX package's list, and the device the run trains on)
_FINGERPRINT_IGNORE = {"num_iterations", "input_model", "output_model",
                       "snapshot_freq", "data", "valid", "output_result",
                       "shard_residency", "split_search",
                       "fused_scan_iters", "device_type"}


def _row_bounds(eng) -> List[List[int]]:
    """``[lo, hi)`` of every rank's rows of the world's score."""
    if not eng._sharded_rows:
        return [[0, int(eng.n_global)]]
    ends = np.cumsum([0] + list(eng.row_counts))
    return [[int(a), int(b)] for a, b in zip(ends[:-1], ends[1:])]


def _params_fingerprint(params) -> Dict[str, str]:
    from ..config import resolve_params
    return {str(k): str(v) for k, v in
            sorted(resolve_params(params or {}).items())
            if k not in _FINGERPRINT_IGNORE}


def _prune(directory: str, keep: int) -> None:
    if keep is None or keep <= 0:
        return
    snaps = sorted(_snapshot_files(directory))
    for _, name in snaps[:-keep]:
        try:
            os.unlink(os.path.join(directory, name))
        except OSError:
            pass


def _snapshot_files(directory: str):
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        m = _FILE_RE.match(name)
        if m:
            out.append((int(m.group(1)), name))
    return out


# ---------------------------------------------------------------------
# read
# ---------------------------------------------------------------------

def load_snapshot(path: str) -> Dict[str, Any]:
    """Load + validate one snapshot. Raises :class:`CheckpointError`
    on anything short of a complete, well-formed file."""
    try:
        with np.load(path, allow_pickle=False) as z:
            files = set(z.files)
            required = {"state_json", "model_str", "score",
                        "frng_keys", "drng_keys"}
            missing = required - files
            if missing:
                raise CheckpointError(
                    f"{path}: missing members {sorted(missing)}")
            state = json.loads(bytes(z["state_json"]).decode("utf-8"))
            if state.get("magic") != CHECKPOINT_MAGIC:
                raise CheckpointError(f"{path}: bad magic "
                                      f"{state.get('magic')!r}")
            snap = dict(state)
            snap["model_str"] = bytes(z["model_str"]).decode("utf-8")
            snap["score"] = np.asarray(z["score"], np.float32)
            snap["frng_keys"] = np.asarray(z["frng_keys"], np.uint32)
            snap["drng_keys"] = np.asarray(z["drng_keys"], np.uint32)
            for key in (*_GENERATORS, "cached_bag"):
                if key in files:
                    snap[key] = np.asarray(z[key], np.uint8)
            for key in ("tree_shrinkage", "tree_internal_value"):
                if key in files:
                    snap[key] = np.asarray(z[key], np.float64)
    except CheckpointError:
        raise
    except Exception as e:  # zip/json/np errors: corrupt or foreign file
        raise CheckpointError(f"{path}: unreadable snapshot ({e})") from e
    if snap["score"].ndim != 2:
        raise CheckpointError(f"{path}: score must be [K, n]")
    snap["path"] = path
    return snap


def load_latest_snapshot(directory: str) -> Optional[Dict[str, Any]]:
    """Newest snapshot in ``directory`` that validates; corrupted or
    truncated files are skipped (with a warning) in favor of the
    previous one. None when the directory holds no usable snapshot."""
    directory = os.fspath(directory)
    for _, name in sorted(_snapshot_files(directory), reverse=True):
        path = os.path.join(directory, name)
        try:
            return load_snapshot(path)
        except CheckpointError as e:
            log_warning(f"checkpoint: skipping invalid snapshot: {e}")
    return None


def list_snapshots(directory: str) -> List[Dict[str, Any]]:
    """Every ``ckpt_*.npz`` in ``directory`` with validation status —
    the ``checkpoints <dir>`` subcommand's rows."""
    out = []
    directory = os.fspath(directory)
    for it, name in sorted(_snapshot_files(directory)):
        path = os.path.join(directory, name)
        row: Dict[str, Any] = {
            "path": path, "iteration": it,
            "bytes": os.path.getsize(path),
            "mtime": os.path.getmtime(path),
        }
        try:
            snap = load_snapshot(path)
            row.update(status="ok", num_trees=snap["num_trees"],
                       best_iteration=snap["best_iteration"])
        except CheckpointError as e:
            row.update(status="corrupt", error=str(e))
        out.append(row)
    return out


# ---------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------

def _bagging_active(cfg) -> bool:
    return cfg.bagging_freq > 0 and (
        cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0
        or cfg.neg_bagging_fraction < 1.0)


def _generators_in_use(eng) -> List[str]:
    """The npz members of the generators this run draws from."""
    cfg = eng.cfg
    used = []
    if cfg.data_sample_strategy == "goss" or _bagging_active(cfg):
        used.append("gen_bag")
    if cfg.feature_fraction_bynode < 1.0:
        used.append("gen_bynode")
    if eng._rounding_gen is not None:
        used.append("gen_rounding")
    return used


def _restore_generators(eng, snap: Dict[str, Any], iteration: int) -> None:
    """Install the snapshot's generator states and cached bagging draw,
    or refuse a snapshot that lacks what this run draws from."""
    import torch

    from ..basic import LightGBMError
    missing = [k for k in _generators_in_use(eng) if k not in snap]
    cfg = eng.cfg
    cache_needed = (_bagging_active(cfg)
                    and cfg.data_sample_strategy != "goss"
                    and iteration % cfg.bagging_freq != 0)
    if cache_needed and "cached_bag" not in snap:
        missing.append("cached_bag")
    if missing:
        raise LightGBMError(
            f"checkpoint {snap.get('path')} holds no {', '.join(missing)}: "
            "this run draws from the port's torch.Generators (bagging or "
            "GOSS, feature_fraction_bynode, stochastic rounding), whose "
            "state a resume needs and a JAX package snapshot does not "
            "carry")
    for key, attr in _GENERATORS.items():
        gen = getattr(eng, attr)
        if gen is None or key not in snap:
            continue
        state = torch.from_numpy(np.array(snap[key], np.uint8))
        try:
            gen.set_state(state)
        except RuntimeError as e:
            raise LightGBMError(
                f"checkpoint {snap.get('path')}: the {key} state does not "
                f"fit this run's {gen.device.type} generator (a snapshot "
                "written on another device type)") from e
    if cache_needed:
        bits = np.unpackbits(snap["cached_bag"])[:eng.n_global]
        lo = eng.row_lo if eng._sharded_rows else 0
        eng._cached_bag = torch.as_tensor(
            bits[lo:lo + eng.n].astype(np.float32), device=eng.device)


def _restore_tree_precision(trees, snap: Dict[str, Any]) -> None:
    """The trees' shrinkage and internal values at full precision (the
    model text's ``%g`` rounds them)."""
    iv = snap["tree_internal_value"]
    sizes = [len(t.internal_value) for t in trees]
    if len(snap["tree_shrinkage"]) != len(trees) or sum(sizes) != len(iv):
        raise CheckpointError(f"{snap.get('path')}: tree_shrinkage / "
                              "tree_internal_value do not fit the model")
    at = 0
    for tree, size, shrink in zip(trees, sizes, snap["tree_shrinkage"]):
        tree.internal_value = iv[at:at + size].copy()
        tree.shrinkage = float(shrink)
        at += size


def restore_booster(booster, snap: Dict[str, Any]) -> int:
    """Install a snapshot into a freshly built training Booster and
    return the iteration to continue from."""
    from ..basic import Booster, LightGBMError

    eng = booster._engine
    if eng is None:
        raise LightGBMError("restore requires a Booster built with a "
                            "train_set")
    fp_now = _params_fingerprint(booster.params)
    fp_then = snap.get("params_fingerprint") or {}
    drift = {k for k in set(fp_now) | set(fp_then)
             if fp_now.get(k) != fp_then.get(k)}
    if drift:
        log_warning(
            "checkpoint: resuming with different parameters than the "
            f"snapshot was written with ({', '.join(sorted(drift))}); "
            "the resumed model will not match an uninterrupted run")
    fp_data = snap.get("data_fingerprint")
    if fp_data is not None and fp_data != _dataset_fingerprint(eng):
        raise LightGBMError(
            f"checkpoint {snap.get('path')} was written against "
            "different training data (label/bin fingerprint mismatch) "
            "— refusing to silently continue another run's trees. "
            "Point resume_from/LIGHTGBM_TPU_CHECKPOINT at a fresh "
            "directory for this dataset.")
    parsed = Booster(model_str=snap["model_str"],
                     params={"device_type": eng.device.type})
    trees = parsed._trees
    if len(trees) != int(snap["num_trees"]):
        raise LightGBMError(
            f"checkpoint {snap.get('path')}: model text holds "
            f"{len(trees)} trees, state says {snap['num_trees']}")
    if "tree_shrinkage" in snap:
        _restore_tree_precision(trees, snap)
    score = np.asarray(snap["score"], np.float32)
    if score.shape != (eng.K, eng.n_global):
        raise LightGBMError(
            f"checkpoint {snap.get('path')}: score shape {score.shape} "
            f"does not match this training set [{eng.K}, {eng.n_global}] "
            "— was the checkpoint written against different data?")
    if eng._sharded_rows:
        # this rank's rows of the world's score, checked against their
        # fingerprint when the snapshot's world had this layout
        bounds = _row_bounds(eng)
        lo, hi = bounds[eng.comm.rank]
        fps = snap.get("score_shard_fingerprints")
        if fps is not None and len(fps) == len(bounds):
            from ..parallel import placement
            mine = placement.shard_fingerprints(score, bounds)
            if mine[eng.comm.rank] != fps[eng.comm.rank]:
                raise LightGBMError(
                    f"checkpoint {snap.get('path')}: rank "
                    f"{eng.comm.rank}'s rows of the score do not match "
                    "their shard fingerprint")
        score = score[:, lo:hi]
    iteration = int(snap["iteration"])
    _restore_generators(eng, snap, iteration)
    eng.preload_models(trees, score=score)
    eng.init_iteration = int(snap.get("num_init_iteration", 0))
    eng._resume_stalled = bool(snap.get("stalled", False))
    _rng_restore(eng._feature_rng, snap["frng_keys"], snap["feature_rng"])
    _rng_restore(eng._dart_rng, snap["drng_keys"], snap["dart_rng"])
    booster.best_iteration = int(snap.get("best_iteration", -1))
    booster.best_score = {
        d: dict(sub) for d, sub in (snap.get("best_score") or {}).items()}
    booster._attrs = dict(snap.get("attrs") or {})
    booster._train_data_name = snap.get("train_data_name",
                                        booster._train_data_name)
    return iteration


# ---------------------------------------------------------------------
# callback
# ---------------------------------------------------------------------

@dataclass(eq=False)
class Checkpoint:
    """Periodic atomic snapshot callback (after-iteration, order 50 so
    the iteration's telemetry event lands first)."""
    directory: str
    every_n_iters: int = 1
    keep: int = 3
    order: int = 50
    before_iteration: bool = False
    _warned_unsupported: bool = False

    def __call__(self, env) -> None:
        eng = getattr(env.model, "_engine", None)
        if eng is None:
            if not self._warned_unsupported:
                self._warned_unsupported = True
                log_warning("checkpoint: cv()/CVBooster checkpointing is "
                            "not supported; callback disabled")
            return
        it = int(eng.iter_)
        last = env.iteration + 1 >= env.end_iteration
        if it <= 0 or (not last and self.every_n_iters > 1
                       and it % self.every_n_iters != 0):
            return
        score_host = bag_host = None
        if eng.comm is not None:
            # every rank holds the same model: check that, then every
            # rank joins the gathers above the rank gate; rank 0 writes
            from ..parallel import placement
            from ..parallel.spmd import verify_step_consistency
            verify_step_consistency(it, len(eng.models))
            _dataset_fingerprint(eng)
            if eng._sharded_rows:
                score_host = placement.fetch_global(eng.score, eng.comm,
                                                    eng.row_counts)
                if eng._cached_bag is not None:
                    bag_host = placement.fetch_global(
                        eng._cached_bag, eng.comm, eng.row_counts)
            if eng.comm.rank != 0:
                return
        path = write_snapshot(self.directory, env.model, keep=self.keep,
                              score_host=score_host, bag_host=bag_host)
        log_info(f"checkpoint: wrote {path}")


def checkpoint(directory: str, every_n_iters: int = 1,
               keep: int = 3) -> Checkpoint:
    """Create the checkpoint callback: atomically snapshot the model
    and training state into ``directory`` every ``every_n_iters``
    boosting iterations (and at the final one), retaining the ``keep``
    newest snapshots. Pair with ``train(..., resume_from=directory)``
    or ``LIGHTGBM_TPU_CHECKPOINT=<directory>`` to survive crashes."""
    if every_n_iters <= 0:
        raise ValueError("every_n_iters must be positive")
    return Checkpoint(directory=os.fspath(directory),
                      every_n_iters=int(every_n_iters), keep=int(keep))

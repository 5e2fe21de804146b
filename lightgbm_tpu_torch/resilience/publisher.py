"""Atomic model publication: the train -> serve handoff over a store.

A copy of ``lightgbm_tpu/resilience/publisher.py``, with the same
manifest magic (:data:`MANIFEST_MAGIC`), so each package validates and
serves the other's publications. The serving daemon
(``serve/daemon.py``) polls a watch target for the newest artifact;
this module is the writer side of that contract, and it must survive
being killed at any byte. Every verb rides an
:class:`~.store.ArtifactStore`: a path publishes into a local
directory, ``mem://<name>`` into the faultable in-process object store.

Protocol (manifest first):

1. ``<name>.manifest.json`` is put atomically, carrying the artifact's
   byte length and sha256, caller metadata and, when the caller gives
   one, a **canary**: validation rows and the raw scores the publishing
   model gave them. The manifest lands before the model blob, so every
   model artifact a watcher observes can be validated, and a replica
   can score the canary through its compiled forest before it swaps.
2. ``<name>`` (the model text) is put atomically.

A model whose bytes do not match its manifest is a torn publication
(a writer that died between the two puts): the daemon skips it with a
``swap_failure`` fault event and retries at its next poll. Artifacts
without a manifest (hand-dropped model files, checkpoint snapshots)
are served once they parse.

Transient failures (a full disk, a store outage, the injected
``publish_torn@G`` / ``store_outage@G`` kinds) are retried with
jittered exponential backoff and counted in the ``publish_retries`` /
``publish_backoff_seconds`` registry counters. ``publish_poison@G``
publishes a byte-valid manifest whose canary expectations are wrong,
which only the daemon's canary gate can catch.

This module imports no torch.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.registry import bump_counter as _count
from ..log import log_info, log_warning
from .store import ArtifactStore, LocalDirStore, StoreError, store_for

__all__ = ["PublishError", "publish_model", "manifest_path",
           "load_manifest", "load_manifest_in", "validate_artifact",
           "validate_artifact_in", "latest_manifest",
           "latest_manifest_in", "prune_publications",
           "rollback_publication"]

MANIFEST_MAGIC = "lightgbm_tpu.publish.v1"
MANIFEST_SUFFIX = ".manifest.json"

#: retry/backoff defaults, overridable per call
DEFAULT_RETRIES = 5
DEFAULT_BACKOFF_SEC = 0.25
BACKOFF_CAP_SEC = 15.0


class PublishError(RuntimeError):
    """A model publication failed (exhausted retries), or an artifact
    failed its manifest validation (torn / partial write)."""


def manifest_path(model_path) -> str:
    return os.fspath(model_path) + MANIFEST_SUFFIX


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _is_store_target(target) -> bool:
    if isinstance(target, ArtifactStore):
        return True
    try:
        return os.fspath(target).startswith("mem://")
    except TypeError:
        return False


def _poison_scores(scores):
    """Shift every canary expectation far outside any tolerance —
    byte-valid, semantically garbage (the ``publish_poison`` shape)."""
    if isinstance(scores, (list, tuple)):
        return [_poison_scores(s) for s in scores]
    return float(scores) + 1.0e3


def publish_model(model, directory, name: str, *,
                  metadata: Optional[Dict[str, Any]] = None,
                  canary: Optional[Dict[str, Any]] = None,
                  retries: int = DEFAULT_RETRIES,
                  backoff_base_sec: float = DEFAULT_BACKOFF_SEC,
                  fault_iteration: int = -1,
                  keep: int = 0,
                  protect_shas=(),
                  _sleep: Callable[[float], None] = time.sleep,
                  _rng: Callable[[], float] = random.random
                  ) -> Dict[str, Any]:
    """Publish ``model`` into ``directory`` as ``name`` with a
    validating manifest; returns the manifest dict.

    ``directory`` is any store target (a local directory path, a
    ``mem://`` spec, or an :class:`~.store.ArtifactStore`). ``model``
    is a model-text string or anything with ``model_to_string()`` (a
    Booster). ``metadata`` is merged into the manifest (generation
    number, data digest, train metrics — whatever the retrain loop
    wants the serve side and post-mortems to see). ``canary`` — a dict
    of ``{"rows": [[...]], "scores": [...], "tol": float}`` — embeds
    the serve-side validation batch (the daemon's canary gate).
    ``fault_iteration`` keys the ``publish_torn@G`` /
    ``store_outage@G`` / ``publish_poison@G`` chaos kinds (typically
    the retrain generation number). ``keep`` > 0 prunes publications
    beyond the ``keep`` newest valid manifests after a successful
    publish (``protect_shas`` are never pruned — the currently-served
    / last-known-good models).

    Transient failures (OSError — which store outages subclass — and
    injected tears) retry up to ``retries`` times with jittered
    exponential backoff (``backoff_base_sec`` doubling per attempt,
    capped at 15 s, x[0.5, 1.5) jitter); exhaustion raises
    :class:`PublishError`.
    """
    if not isinstance(model, str):
        model = model.model_to_string()
    t_start = time.perf_counter()
    payload = model.encode("utf-8")
    store = store_for(directory)
    where = store.url
    # trace context (obs/trace.py): inherit the publishing process's
    # current trace (the pipeline supervisor's per-generation context,
    # via LIGHTGBM_TPU_TRACE_CTX) or start a fresh one, and stamp it
    # INTO the manifest — the serve watcher's validate->load->swap
    # spans then correlate back to the generation that published
    from ..obs import trace as _trace
    ctx = _trace.current_context()
    trace_id = ctx["trace_id"] if ctx else _trace.new_trace_id()
    parent_id = ctx["span_id"] if ctx else None
    span_id = _trace.new_span_id()
    manifest = {
        "magic": MANIFEST_MAGIC,
        "file": name,
        "bytes": len(payload),
        "sha256": _sha256_hex(payload),
        "created_unix": time.time(),
        "trace": {"trace_id": trace_id, "span_id": span_id},
        **(metadata or {}),
    }
    from .faults import FaultPlan, record_fault_event
    plan = FaultPlan.from_env()
    if canary:
        if plan.take("publish_poison", fault_iteration):
            # chaos: the publication stays byte-valid (manifest sha
            # matches the model blob) but its canary expectations are
            # garbage — indistinguishable from a trainer that
            # published a broken model. sha256 validation MUST accept
            # it; only the serve-side canary gate can refuse it.
            canary = dict(canary,
                          scores=_poison_scores(canary.get("scores")))
            record_fault_event(
                "publish_poison", iteration=fault_iteration,
                action="published_poisoned",
                detail=f"injected poisoned canary in {name} "
                       "(LIGHTGBM_TPU_FAULT_INJECT)")
        manifest["canary"] = canary
    last_err: Optional[BaseException] = None
    for attempt in range(max(0, int(retries)) + 1):
        try:
            if plan.take("store_outage", fault_iteration):
                # chaos: the transport is down for this attempt — the
                # retry/backoff loop must carry the publication through
                record_fault_event(
                    "store_outage", iteration=fault_iteration,
                    action="retry",
                    detail=f"injected store outage publishing {name} "
                           "(LIGHTGBM_TPU_FAULT_INJECT)")
                raise StoreError(
                    f"injected store outage publishing {name} "
                    "(LIGHTGBM_TPU_FAULT_INJECT)")
            # manifest FIRST: every model artifact a watcher can ever
            # observe under this protocol is validatable
            store.put_bytes(
                name + MANIFEST_SUFFIX,
                (json.dumps(manifest) + "\n").encode("utf-8"))
            if plan.take("publish_torn", fault_iteration):
                # chaos: leave the torn artifact a crashed / non-atomic
                # writer would — a partial prefix — then fail this
                # attempt so the retry loop (and the watcher's
                # validation) must both do their jobs
                store.put_bytes(
                    name, payload[: max(1, len(payload) // 3)])
                record_fault_event(
                    "publish_torn", iteration=fault_iteration,
                    action="retry",
                    detail=f"injected torn publish of {name} "
                           "(LIGHTGBM_TPU_FAULT_INJECT)")
                raise PublishError(
                    f"injected torn publish of {name} "
                    "(LIGHTGBM_TPU_FAULT_INJECT)")
            store.put_bytes(name, payload)
        except (OSError, PublishError) as e:
            last_err = e
            if attempt >= retries:
                break
            delay = min(BACKOFF_CAP_SEC,
                        float(backoff_base_sec) * (2 ** attempt))
            delay *= 0.5 + _rng()            # jitter: x[0.5, 1.5)
            _count("publish_retries")
            _count("publish_backoff_seconds", delay)
            log_warning(f"publish: attempt {attempt + 1} for {name} "
                        f"failed ({e}); retrying in {delay:.2f}s")
            _sleep(delay)
            continue
        _count("publish_total")
        _trace.record_span(
            "publish/model", t_start, trace_id=trace_id,
            span_id=span_id, parent_id=parent_id,
            attrs={"file": name,
                   "generation": (metadata or {}).get("generation"),
                   "sha256": manifest["sha256"][:12],
                   "attempts": attempt + 1})
        log_info(f"publish: wrote {name} into {where} "
                 f"({len(payload)} bytes, sha256 "
                 f"{manifest['sha256'][:12]}…)")
        if keep > 0:
            # retention failures must never fail a successful publish
            try:
                prune_publications(
                    store, keep,
                    protect_shas=(tuple(protect_shas)
                                  + (manifest["sha256"],)))
            except (OSError, PublishError) as e:
                log_warning(f"publish: retention prune in {where} "
                            f"failed ({e}); will retry next publish")
        return manifest
    _count("publish_failures")
    raise PublishError(
        f"publishing {name} into {where} failed after "
        f"{retries + 1} attempt(s): {last_err}") from last_err


def load_manifest_in(store: ArtifactStore,
                     name: str) -> Optional[Dict[str, Any]]:
    """The manifest published alongside blob ``name`` in ``store``, or
    None when the artifact is unmanaged (no sidecar). A sidecar that
    exists but is unreadable/foreign raises :class:`PublishError` — a
    manifest is put atomically, so garbage there is corruption, not a
    mid-write artifact."""
    where = f"{store.url}/{name + MANIFEST_SUFFIX}"
    try:
        raw = store.get_bytes(name + MANIFEST_SUFFIX)
    except FileNotFoundError:
        return None
    except OSError as e:
        raise PublishError(f"{where}: unreadable manifest ({e})") from e
    try:
        manifest = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise PublishError(f"{where}: malformed manifest ({e})") from e
    if not isinstance(manifest, dict) \
            or manifest.get("magic") != MANIFEST_MAGIC:
        raise PublishError(f"{where}: bad manifest magic "
                           f"{manifest.get('magic') if isinstance(manifest, dict) else None!r}")
    return manifest


def load_manifest(model_path) -> Optional[Dict[str, Any]]:
    """Path-flavored :func:`load_manifest_in` (shared-filesystem
    callers)."""
    path = os.fspath(model_path)
    return load_manifest_in(LocalDirStore(os.path.dirname(path) or "."),
                            os.path.basename(path))


def validate_artifact_in(store: ArtifactStore,
                         name: str) -> Optional[Dict[str, Any]]:
    """Validate blob ``name`` against its published manifest.

    Returns the manifest when the bytes match, None when the artifact
    carries no manifest (legacy / hand-dropped file — the caller
    decides whether to trust it), and raises :class:`PublishError` on
    a mismatch: the artifact is torn (a publisher died between the
    manifest and the model put, or a non-atomic writer is mid-way
    through) and must not be served."""
    manifest = load_manifest_in(store, name)
    if manifest is None:
        return None
    try:
        data = store.get_bytes(name)
    except FileNotFoundError:
        data = b""
    if len(data) != int(manifest.get("bytes", -1)) \
            or _sha256_hex(data) != manifest.get("sha256"):
        raise PublishError(
            f"{store.url}/{name}: torn or partial artifact — "
            f"{len(data)} bytes in store vs {manifest.get('bytes')} "
            "published (sha256 mismatch); a publisher retry or the "
            "next atomic replace will supersede it")
    return manifest


def validate_artifact(model_path) -> Optional[Dict[str, Any]]:
    """Path-flavored :func:`validate_artifact_in` (shared-filesystem
    callers)."""
    path = os.fspath(model_path)
    return validate_artifact_in(
        LocalDirStore(os.path.dirname(path) or "."),
        os.path.basename(path))


def _manifest_entries(
        store: ArtifactStore
        ) -> List[Tuple[float, str, Dict[str, Any]]]:
    """``(created_unix, model_name, manifest)`` for every loadable
    manifest in ``store``, unsorted; unusable sidecars are skipped
    with a warning."""
    entries: List[Tuple[float, str, Dict[str, Any]]] = []
    for nm in store.list_names():
        if not nm.endswith(MANIFEST_SUFFIX):
            continue
        model_name = nm[: -len(MANIFEST_SUFFIX)]
        try:
            manifest = load_manifest_in(store, model_name)
        except PublishError as e:
            log_warning(f"publish: skipping unusable publication "
                        f"{store.url}/{model_name} ({e})")
            continue
        if manifest is None:
            continue
        entries.append(
            (float(manifest.get("created_unix", 0.0)), model_name,
             manifest))
    return entries


def latest_manifest_in(
        store: ArtifactStore
        ) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Newest VALIDATED publication in ``store``: ``(name, manifest)``
    by manifest creation time, skipping torn or unreadable entries
    (with a warning). None when nothing validates — the warm-start
    path then trains from scratch.

    Ordering comes from the (cheap, json-read) manifests alone;
    artifact bytes are only hashed newest-first until one validates —
    a long-lived publish target is not re-hashed end to end on every
    generation."""
    entries = _manifest_entries(store)
    for _, name, manifest in sorted(entries, reverse=True,
                                    key=lambda c: (c[0], c[1])):
        try:
            if validate_artifact_in(store, name) is not None:
                return name, manifest
        except (PublishError, OSError) as e:
            log_warning(f"publish: skipping unusable publication "
                        f"{store.url}/{name} ({e})")
    return None


def latest_manifest(target) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Newest validated publication in ``target`` (any store target).

    For a directory path the first element is the joined model PATH;
    for a store / ``mem://`` target it is the blob name."""
    if _is_store_target(target):
        return latest_manifest_in(store_for(target))
    directory = os.fspath(target)
    found = latest_manifest_in(LocalDirStore(directory))
    if found is None:
        return None
    name, manifest = found
    return os.path.join(directory, name), manifest


def prune_publications(target, keep: int,
                       protect_shas=()) -> List[str]:
    """Prune publications beyond the ``keep`` newest valid manifests;
    returns the pruned model names.

    Publications whose sha256 is in ``protect_shas`` (the
    currently-served model, the last-known-good rollback target) are
    never pruned, wherever they rank. The artifact blob is deleted
    BEFORE its manifest: a prune that dies half-way leaves a
    manifest-without-artifact, which every reader already skips as
    torn — never a bare, manifest-less model file that the legacy
    watcher path would trust."""
    if keep <= 0:
        return []
    store = store_for(target)
    protect = set(protect_shas)
    entries = sorted(_manifest_entries(store), reverse=True,
                     key=lambda c: (c[0], c[1]))
    pruned: List[str] = []
    for rank, (_, name, manifest) in enumerate(entries):
        if rank < keep or manifest.get("sha256") in protect:
            continue
        store.delete(name)
        store.delete(name + MANIFEST_SUFFIX)
        pruned.append(name)
        _count("publish_pruned")
    if pruned:
        log_info(f"publish: pruned {len(pruned)} publication(s) "
                 f"beyond the {keep} newest from {store.url}")
    return pruned


def rollback_publication(target, bad_name: str, good_name: str, *,
                         retries: int = DEFAULT_RETRIES,
                         backoff_base_sec: float = DEFAULT_BACKOFF_SEC
                         ) -> Dict[str, Any]:
    """Supersede a bad publication with a re-publication of a known
    good one; returns the new manifest.

    The bad blob and its manifest are deleted first (artifact before
    manifest, same torn-safe order as pruning) so no watcher can pick
    the bad publication up again, then ``good_name``'s bytes are
    re-published under a fresh name — newest-wins polling then swaps
    every replica (back) onto the good model, including replicas that
    never saw it. The new manifest carries ``rollback_of`` (the bad
    sha) and the good publication's canary/generation metadata."""
    store = store_for(target)
    good_manifest = load_manifest_in(store, good_name)
    if good_manifest is None:
        raise PublishError(
            f"rollback target {store.url}/{good_name} has no manifest")
    data = store.get_bytes(good_name)
    if _sha256_hex(data) != good_manifest.get("sha256"):
        raise PublishError(
            f"rollback target {store.url}/{good_name} failed its own "
            "manifest validation; refusing to republish it")
    bad_sha = ""
    try:
        bad = load_manifest_in(store, bad_name)
        bad_sha = (bad or {}).get("sha256", "")
    except PublishError:
        pass
    store.delete(bad_name)
    store.delete(bad_name + MANIFEST_SUFFIX)
    metadata = {k: good_manifest[k]
                for k in ("generation", "train_auc", "refit_auc",
                          "data_digest")
                if k in good_manifest}
    metadata["rollback_of"] = bad_sha or bad_name
    new_name = f"rollback_{(bad_sha or 'unknown')[:8]}_{good_name}"
    manifest = publish_model(
        data.decode("utf-8"), store, new_name, metadata=metadata,
        canary=good_manifest.get("canary"), retries=retries,
        backoff_base_sec=backoff_base_sec)
    _count("publish_rollbacks")
    log_info(f"publish: rolled back {bad_name} "
             f"(sha {bad_sha[:12] or '?'}…) to {good_name} "
             f"as {new_name}")
    return manifest

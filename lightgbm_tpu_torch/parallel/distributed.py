"""Joining a world of ranks: ``init_distributed`` on
``torch.distributed`` (the JAX package's ``parallel/distributed.py``).

``init_distributed`` wraps ``torch.distributed.init_process_group`` with
``init_method="tcp://<coordinator>"``. It takes the JAX package's
arguments and the reference's machine-list vocabulary:

    # launch supervisor (python -m lightgbm_tpu_torch launch N): no
    # arguments, LIGHTGBM_TPU_COORDINATOR / _NUM_PROCS / _RANK
    init_distributed()
    # reference style ("host:port" entries, the first is rank 0's)
    init_distributed(machines="10.0.0.1:12400,10.0.0.2:12400",
                     local_rank=1)
    # explicit
    init_distributed(coordinator_address="127.0.0.1:12400",
                     num_processes=2, process_id=1)

A refused or unreachable coordinator is retried with jittered
exponential backoff (``LIGHTGBM_TPU_INIT_RETRIES``, default 10;
``LIGHTGBM_TPU_INIT_BACKOFF``, default 0.5 s, doubled per attempt,
capped at 15 s; ``LIGHTGBM_TPU_INIT_TIMEOUT``, the rendezvous timeout in
seconds), counted in the ``init_retries`` and ``init_backoff_seconds``
registry counters.

The backend is a rule, not a fallback (:func:`choose_backend`):

- ``nccl`` when every rank is on a CUDA device of its own;
- ``gloo`` on the CPU;
- ``gloo`` on CUDA tensors when ranks share one card (NCCL refuses two
  ranks on one device).

The ranks that share a host are counted from the machine list (the
entries with this rank's host); a world of the launch supervisor or of
an explicit coordinator is one host. Every host is taken to run as many
ranks as this one. A failed NCCL init raises; it never switches to gloo.
The ``i``-th rank of a host takes ``cuda:(i % device_count)``. The
backend in use is logged.
"""

from __future__ import annotations

import os
import random
import re
import time
from datetime import timedelta
from typing import List, Optional, Tuple

from ..log import log_info, log_warning

__all__ = ["init_distributed", "shutdown_distributed", "parse_machines",
           "choose_backend", "local_layout", "rank_device", "init_seconds"]

#: backoff schedule bound (seconds)
_BACKOFF_CAP = 15.0

#: substrings that mark an initialization error as transient: the
#: coordinator process is not up yet or is still binding its port
_RETRYABLE_MARKERS = ("connection refused", "unavailable",
                      "failed to connect", "connection reset",
                      "deadline_exceeded", "deadline exceeded")

#: this process's world: its device, backend and the seconds
#: init_process_group took (None before init_distributed)
_STATE: dict = {}


def parse_machines(machines: Optional[str] = None,
                   machine_list_file: Optional[str] = None
                   ) -> List[Tuple[str, int]]:
    """Parse the reference's machine-list formats: a comma/newline
    separated ``host:port`` string (config ``machines``) or a file with
    one ``host port`` / ``host:port`` per line (``machine_list_file``).
    Blank entries and surrounding whitespace are ignored; a malformed
    entry raises ``ValueError`` naming it."""
    entries: List[str] = []
    if machines:
        entries = machines.replace("\n", ",").split(",")
    elif machine_list_file:
        with open(machine_list_file) as fh:
            entries = list(fh)
    out = []
    for raw in entries:
        e = raw.strip()
        if not e:
            continue
        parts = [p for p in re.split(r"[\s:]+", e) if p]
        if len(parts) > 2:
            raise ValueError(f"bad machine-list entry {e!r} "
                             "(expected 'host:port' or 'host port')")
        host = parts[0]
        port_str = parts[1] if len(parts) == 2 else "0"
        try:
            port = int(port_str)
        except ValueError:
            raise ValueError(f"bad port {port_str!r} in machine-list "
                             f"entry {e!r}") from None
        out.append((host, port))
    return out


def choose_backend(device_type: str, local_procs: int,
                   num_cuda: int) -> str:
    """The backend rule: ``nccl`` when each of the ``local_procs`` ranks
    of a host has one of its ``num_cuda`` CUDA devices of its own,
    ``gloo`` on the CPU and when ranks share a card."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if num_cuda >= local_procs else "gloo"


def local_layout(hosts: Optional[List[str]], rank: int,
                 nprocs: int) -> Tuple[int, int]:
    """``(ranks on this rank's host, this rank's index among them)``:
    from the machine list's hosts (one entry a rank), or one host for
    all ``nprocs`` ranks when there is no list."""
    if not hosts:
        return nprocs, rank
    mine = hosts[rank]
    return hosts.count(mine), hosts[:rank].count(mine)


def rank_device():
    """This rank's device: the one ``init_distributed`` chose, else the
    current CUDA device, else the CPU."""
    import torch
    if "device" in _STATE:
        return _STATE["device"]
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_seconds() -> Optional[float]:
    """Seconds ``init_process_group`` took in this process (None before
    a world was joined)."""
    return _STATE.get("init_seconds")


def _is_retryable_init_error(exc: BaseException) -> bool:
    msg = str(exc).lower()
    return any(m in msg for m in _RETRYABLE_MARKERS)


def _initialize_with_retry(backend: str, address: str, nprocs: int,
                           rank: int) -> None:
    """``init_process_group`` with jittered exponential backoff on
    coordinator-not-up errors (the reference's ``Network::Init`` retry
    loop). Raises ``LightGBMError`` with the attempt history when the
    retries run out."""
    import torch.distributed as dist

    from ..basic import LightGBMError
    from ..obs.registry import registry
    from ..resilience import watchdog
    from ..resilience.faults import FaultPlan

    plan = FaultPlan.from_env()
    max_retries = int(os.environ.get("LIGHTGBM_TPU_INIT_RETRIES", "10"))
    base = float(os.environ.get("LIGHTGBM_TPU_INIT_BACKOFF", "0.5"))
    # the process group's own timeout backs the watchdog up: a collective
    # left waiting on a dead peer ends with an error instead of a hang
    limit = watchdog.deadline_seconds()
    kw = {}
    if limit > 0:
        kw["timeout"] = timedelta(seconds=max(30.0, 2 * limit))
    env_timeout = os.environ.get("LIGHTGBM_TPU_INIT_TIMEOUT")
    if env_timeout:
        kw["timeout"] = timedelta(seconds=float(env_timeout))
    total_wait = 0.0
    for attempt in range(max_retries + 1):
        try:
            plan.maybe_refuse_init()
            t0 = time.perf_counter()
            dist.init_process_group(backend, init_method=f"tcp://{address}",
                                    world_size=nprocs, rank=rank, **kw)
            _STATE["init_seconds"] = time.perf_counter() - t0
            if attempt:
                log_info(f"init_distributed: connected after {attempt} "
                         f"retried attempt(s), {total_wait:.2f}s of "
                         "backoff")
            return
        except Exception as e:
            if not _is_retryable_init_error(e):
                raise
            if attempt >= max_retries:
                raise LightGBMError(
                    f"init_distributed: coordinator {address} still "
                    f"unreachable after {attempt + 1} attempts "
                    f"({total_wait:.2f}s of backoff): {e}. Is the "
                    "coordinator process up? Raise "
                    "LIGHTGBM_TPU_INIT_RETRIES / "
                    "LIGHTGBM_TPU_INIT_BACKOFF for slower bring-up."
                ) from e
            delay = min(_BACKOFF_CAP, base * (2.0 ** attempt))
            delay *= 0.5 + 0.5 * random.random()   # jitter: 50-100%
            registry.counter("init_retries").inc()
            registry.counter("init_backoff_seconds").inc(delay)
            log_warning(f"init_distributed: attempt {attempt + 1} failed "
                        f"({e}); retrying in {delay:.2f}s")
            total_wait += delay
            time.sleep(delay)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     machines: Optional[str] = None,
                     machine_list_file: Optional[str] = None,
                     local_rank: Optional[int] = None,
                     device_type: str = "cuda") -> None:
    """Join this process to a world of ranks (``LGBM_NetworkInit``),
    retrying while the coordinator comes up.

    With reference-style arguments the first machine is the coordinator
    and ``local_rank`` (or ``LIGHTGBM_TPU_RANK``) is this process's
    rank; a single-entry list is a no-op (``num_machines=1``). With no
    arguments, the launch supervisor's ``LIGHTGBM_TPU_COORDINATOR`` /
    ``_NUM_PROCS`` / ``_RANK`` are read; without them too, this is a
    world of one and nothing is joined. ``device_type`` is ``"cuda"``
    (each rank on ``cuda:(rank % device_count)``) or ``"cpu"``."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    hosts = None
    if coordinator_address is None and (machines or machine_list_file):
        mlist = parse_machines(machines, machine_list_file)
        hosts = [h for h, _ in mlist]
        if len(mlist) <= 1:
            return  # num_machines=1: nothing to wire
        host, port = mlist[0]
        coordinator_address = f"{host}:{port}"
        num_processes = len(mlist)
        if process_id is None:
            rank = local_rank if local_rank is not None else int(
                os.environ.get("LIGHTGBM_TPU_RANK") or -1)
            if rank < 0:
                raise ValueError(
                    "machine-list initialization needs local_rank (or "
                    "env LIGHTGBM_TPU_RANK) to identify this process")
            process_id = rank
    if coordinator_address is None and num_processes is None:
        env_coord = os.environ.get("LIGHTGBM_TPU_COORDINATOR")
        if not env_coord:
            return  # a world of one
        nproc_env = os.environ.get("LIGHTGBM_TPU_NUM_PROCS")
        rank_env = os.environ.get("LIGHTGBM_TPU_RANK")
        if nproc_env is None or rank_env is None:
            raise ValueError(
                "LIGHTGBM_TPU_COORDINATOR is set but "
                "LIGHTGBM_TPU_NUM_PROCS / LIGHTGBM_TPU_RANK are not — "
                "all three are required (the launch supervisor exports "
                "them together; see docs/RESILIENCE.md)")
        coordinator_address = env_coord
        num_processes = int(nproc_env)
        process_id = int(rank_env)
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed needs coordinator_address, "
                         "num_processes and process_id together")
    nproc, rank = int(num_processes), int(process_id)
    local_procs, local_index = local_layout(hosts, rank, nproc)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed(device_type='cuda') but torch.cuda is "
                "not available; pass device_type='cpu' for a gloo world "
                "on the CPU")
        ncuda = torch.cuda.device_count()
        device = torch.device("cuda", local_index % ncuda)
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        ncuda = 0
        device = torch.device("cpu")
    else:
        raise ValueError(f"device_type={device_type!r}: 'cuda' or 'cpu'")
    backend = choose_backend(device_type, local_procs, ncuda)
    _initialize_with_retry(backend, coordinator_address, nproc, rank)
    _STATE.update(device=device, backend=backend)
    log_info(f"init_distributed: rank {rank} of {nproc} on {device}, "
             f"backend {backend} ({_STATE['init_seconds']:.3f}s)")


def shutdown_distributed() -> None:
    """Leave the world (``MPI_Finalize`` / ``LGBM_NetworkFree``)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    dist.destroy_process_group()
    _STATE.clear()

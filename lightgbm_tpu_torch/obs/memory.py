"""Device memory gauges of the training device.

The counterpart of ``lightgbm_tpu/obs/memory.py``: the same three keys,
``bytes_in_use`` (``torch.cuda.memory_allocated``), ``peak_bytes_in_use``
(``torch.cuda.max_memory_allocated``, the caching allocator's peak since
its last reset) and ``bytes_limit`` (the card's total memory,
``torch.cuda.mem_get_info``). All three are None on the CPU, and when
the query fails: telemetry degrades, training never breaks. No query
launches anything on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["device_memory_stats"]

_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_stats(device=None) -> Dict[str, Optional[int]]:
    """The gauges of ``device`` (a CUDA ``torch.device``; None: the
    current CUDA device when CUDA is initialized, else nulls)."""
    out: Dict[str, Optional[int]] = {k: None for k in _KEYS}
    if device is None:
        if not torch.cuda.is_initialized():
            return out
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return out
    try:
        stats = torch.cuda.memory_stats(device)
        out["bytes_in_use"] = int(stats.get("allocated_bytes.all.current",
                                            0))
        out["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak",
                                                 0))
        out["bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    except Exception:
        return {k: None for k in _KEYS}
    return out

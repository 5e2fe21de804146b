"""Mini single-source registry for the contract-pass fixtures
(TPL015-TPL018). Same literal-dict shape as the real
lightgbm_tpu_torch/obs/schemas.py — the rules literal-eval THIS tree's copy,
so fixture findings never depend on the installed package."""

EVENTS = {
    "ping": {
        "doc": "one line per ping",
        "required": ("event", "seq"),
        "optional": ("note",),
    },
    "pong": {
        "doc": "one line per pong",
        "required": ("event",),
        "optional": ("latency",),
    },
}

METRICS = {
    "pings": {"kind": "counter", "labels": (), "doc": "pings sent"},
    "ping_depth": {"kind": "gauge", "labels": ("lane",),
                   "doc": "queue depth per lane"},
    "ping_ms": {"kind": "histogram", "labels": (),
                "doc": "ping latency"},
}

EXPORT_FAMILIES = {}

ENV_VARS = {
    "LIGHTGBM_TPU_PING": {"default": "1", "kind": "str",
                          "doc": "ping cadence"},
    "LIGHTGBM_TPU_PONG": {"default": None, "kind": "str",
                          "doc": "pong path (unset: disabled)"},
}

FAULT_KINDS = {
    "ping_kill": {"one_shot": True, "doc": "kill the pinger once"},
    "ping_slow": {"one_shot": False, "doc": "slow every ping"},
}

FAULT_EVENT_KINDS = {
    "ping_seen": {"doc": "observational: a ping was observed"},
}

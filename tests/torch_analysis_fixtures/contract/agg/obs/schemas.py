"""Mini registry whose aggregate (whole-tree) contract findings are
the fixture: one declared-but-never-emitted event, one never-bumped
metric family, one never-referenced env var. The EXPECT markers pin
the registry-assignment anchor lines the findings report at."""

# EXPECT: TPL015
EVENTS = {
    "beep": {"doc": "emitted by site.py",
             "required": ("event", "n"), "optional": ()},
    "boop": {"doc": "declared but never emitted -> finding",
             "required": ("event",), "optional": ()},
}

# EXPECT: TPL016
METRICS = {
    "beeps": {"kind": "counter", "labels": (), "doc": "bumped"},
    "boops": {"kind": "counter", "labels": (),
              "doc": "declared but never bumped -> finding"},
}

EXPORT_FAMILIES = {}

# EXPECT: TPL017
ENV_VARS = {
    "LIGHTGBM_TPU_BEEP": {"default": "5", "kind": "str",
                          "doc": "read by site.py"},
    "LIGHTGBM_TPU_BOOP": {"default": None, "kind": "str",
                          "doc": "declared but never read -> finding"},
}

FAULT_KINDS = {}

FAULT_EVENT_KINDS = {}

"""TPL018 positives: fault-kind drift from the registry."""

# EXPECT: TPL018
_KNOWN_KINDS = ("ping_kill",)

# EXPECT: TPL018
_ONE_SHOT_KINDS = ("ping_slow",)


def trip(plan, log):
    # EXPECT: TPL018
    record_fault_event("ping_oops", 0, "raise", "bad kind")
    # observational kinds are legal for writers, not for plan gates
    # EXPECT: TPL018
    if plan.fires("ping_seen", 0):
        pass


def record_fault_event(kind, iteration, action, detail):
    pass

"""TPL018 negatives: tuples and call sites that match the registry."""

_KNOWN_KINDS = ("ping_kill", "ping_slow")

_ONE_SHOT_KINDS = ("ping_kill",)


def trip(plan, log):
    append_fault_event(log, "ping_seen", 0, "", "observed")
    record_fault_event("ping_slow", 3, "sleep", "slowdown")
    if plan.fires("ping_kill", 0):
        pass
    n = plan.take("ping_slow")
    return n


def append_fault_event(log, kind, iteration, action, detail):
    pass


def record_fault_event(kind, iteration, action, detail):
    pass

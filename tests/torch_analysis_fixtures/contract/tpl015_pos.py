"""TPL015 positives: emission and consumer drift from the registry."""


def emit(log, extra):
    # EXPECT: TPL015
    log.append({"event": "pingg", "seq": 1})
    # EXPECT: TPL015
    log.append({"event": "ping", "seq": 2, "color": "red"})
    # EXPECT: TPL015
    log.append({"event": "ping"})


def consume(events):
    total = 0
    for ev in events:
        # EXPECT: TPL015
        if ev.get("event") == "pingg":
            continue
        if ev.get("event") != "ping":
            continue
        # EXPECT: TPL015
        total += ev["volume"]
    return total

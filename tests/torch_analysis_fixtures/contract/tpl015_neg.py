"""TPL015 negatives: declared events, declared keys, spread fills."""


def emit(log, stats):
    log.append({"event": "ping", "seq": 1, "note": "ok"})
    # a **spread may carry the required keys
    log.append({"event": "pong", **stats})


def consume(events):
    latency = 0.0
    for ev in events:
        if ev.get("event") == "pong":
            latency += ev.get("latency") or 0.0
            continue
        if ev.get("event") != "ping":
            continue
        # consumer-local annotations (leading underscore) are exempt
        ev["_stream"] = "s"
        _ = ev["seq"], ev.get("note")
    return latency

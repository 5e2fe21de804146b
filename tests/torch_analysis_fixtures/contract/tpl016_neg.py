"""TPL016 negatives: declared families, kinds, labels — including the
f-string-prefix and literal-loop-table idioms the real tree uses."""


def feed(registry, key):
    registry.counter("pings").inc()
    registry.gauge("ping_depth", lane="fast").set(3)
    registry.histogram("ping_ms").observe(0.25)
    # literal-prefix f-string resolves against declared families
    registry.gauge(f"ping_de{key}").set(1)
    # loop-bound names over an inline literal table resolve too
    for fam, val in (("pings", 1),):
        registry.counter(fam).inc(val)

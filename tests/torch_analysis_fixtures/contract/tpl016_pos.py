"""TPL016 positives: metric bumps that drift from the registry."""


def feed(registry, name):
    # EXPECT: TPL016
    registry.counter("pigns").inc()
    # EXPECT: TPL016
    registry.gauge("pings").set(1)
    # EXPECT: TPL016
    registry.counter("pings", lane="a").inc()
    # EXPECT: TPL016
    registry.gauge("ping_depth").set(2)
    # EXPECT: TPL016
    registry.counter(name).inc()

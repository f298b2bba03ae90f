"""sched_overhead_ms.decode: host time in the engine's monitor poll and
scheduler node choice (timed by the benchmark around the engine instance's
``monitor.poll`` and ``scheduler.select_node``), per request group, in ms."""


def read(ctx):
    win = ctx["window"]
    spent = win.get("sched_ms")
    return sum(spent) / win["groups"] if spent else None

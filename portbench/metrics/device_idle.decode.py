"""device_idle.decode: 1 - (union of the device operations' intervals over
the traced segment's wall time), in %."""

from portbench import trace


def read(ctx):
    seg = ctx["trace"]
    if not seg["device"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(seg["device"]) / seg["wall_s"])

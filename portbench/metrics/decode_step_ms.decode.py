"""decode_step_ms.decode: the device's work per decode step: the union of
the device operations' intervals in the traced segment (decode steps
``trace_steps`` of one group) over its steps, in ms. The host's pace, which
sets the step's wall time, is not in it: that is ``device_idle.decode``'s."""

from portbench import trace


def read(ctx):
    seg = ctx["trace"]
    if not seg.get("steps") or not seg["device"]:
        return None
    return 1e3 * trace.busy_s(seg["device"]) / seg["steps"]

"""flash_roofline.prefill: the summed bound time of the traced segment's
flash attention calls, worked out from their shapes (the family's
``flash_calls``, then ``flops.flash_call`` and ``flops.bound_s``), over the
summed device time of the flash kernel's events, in %. Nothing is read
where the profile holds another count of flash kernels than the wrapper
launched, or none."""

from portbench import flops

#: the kernel's symbol in a profile, one event per launch
SYMBOL = "flash_fwd"


def read(ctx):
    seg = ctx["trace"]
    events = [(a, b) for name, a, b in seg["device"] if SYMBOL in name]
    calls = [c for b, s in seg["calls"] for c in ctx["family"].flash_calls(ctx["cfg"], b, s)]
    if not events or len(events) != seg["launches"]["flash_attention"] or len(events) != len(calls):
        return None
    bound = sum(flops.bound_s(*flops.flash_call(*c)) for c in calls)
    return 100.0 * bound / (sum(b - a for a, b in events) / 1e6)

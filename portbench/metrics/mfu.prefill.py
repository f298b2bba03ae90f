"""mfu.prefill: the model operations of the window's prefill calls (the
benchmark's count, the family's ``prefill_flops`` in
``reference/<family>.py``) over the window's wall time at the H100's dense
bf16 peak, in %."""

from portbench.bench import PEAK_BF16_FLOPS


def read(ctx):
    win = ctx["window"]
    if not win.get("calls"):
        return None
    done = sum(ctx["family"].prefill_flops(ctx["cfg"], b, s) for b, s in win["calls"])
    return 100.0 * done / (win["wall_s"] * PEAK_BF16_FLOPS)

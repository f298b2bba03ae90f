"""launches_per_step.decode: kernel events (copies and fills left out) per
decode step in the traced segment."""

from portbench import trace


def read(ctx):
    seg = ctx["trace"]
    kernels = sum(1 for name, _, _ in seg["device"] if trace.is_kernel(name))
    return kernels / seg["steps"] if kernels else None

"""Device kernels and copies a step: every device event of the traced
runs over the engine steps they ran (drain steps included).  It counts
what the host has to launch, so fewer launches a step show here first."""


def read(ctx):
    if not ctx.device_events:
        return None
    return ctx.device_events / ctx.steps

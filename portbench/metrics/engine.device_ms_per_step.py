"""Device milliseconds a step outside the four custom kernels: PyTorch's
payload-wide index work in ``core/park.py`` and the engine (the shifts,
gathers and selects over (pipes, packets, pmax), the ring, the merged
stacking), the small launches and the copies, summed by event over the
traced runs and divided by the engine steps they ran."""

CUSTOM = ("split_control_kernel", "payload_store_kernel", "nf_chain_kernel",
          "merge_stage_kernel")


def read(ctx):
    if not ctx.device_events:
        return None
    total = sum(sec for _, sec in ctx.kernels.values())
    return 1e3 * (total - ctx.kernel_seconds(CUSTOM)) / ctx.steps

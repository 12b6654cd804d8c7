"""Merge's share of its roofline: the least time the returning packets'
Merge work needs (``roofline.merge_need``) over the device time of the
kernel that validates their tags, frees their rows and gathers the
parked payloads."""
from portbench import roofline

KERNELS = ("merge_stage_kernel",)


def read(ctx):
    seconds = ctx.kernel_seconds(KERNELS)
    if not seconds:
        return None
    need = roofline.merge_need(ctx.counters, ctx.telemetry)
    return 100.0 * roofline.bound_s(*need) / seconds

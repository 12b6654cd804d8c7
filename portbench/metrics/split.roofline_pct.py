"""Split's share of its roofline: the least time the packets' Split work
needs (``roofline.split_need``) over the device time of the kernels that do
it, the tagger and metadata probe and the payload table's stores."""
from portbench import roofline

KERNELS = ("split_control_kernel", "payload_store_kernel")


def read(ctx):
    seconds = ctx.kernel_seconds(KERNELS)
    if not seconds:
        return None
    need = roofline.split_need(ctx.counters, ctx.telemetry)
    return 100.0 * roofline.bound_s(*need) / seconds

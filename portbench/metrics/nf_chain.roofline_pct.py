"""The NF chain's share of its roofline: the least time the chain's header
work needs (``roofline.nf_chain_need``) over the device time of the kernel
that runs the firewall, NAT's walk and the LB in one launch."""
from portbench import roofline

KERNELS = ("nf_chain_kernel",)


def read(ctx):
    seconds = ctx.kernel_seconds(KERNELS)
    if not seconds:
        return None
    need = roofline.nf_chain_need(ctx.telemetry, ctx.config["chain"],
                                  ctx.config["fw_rules"])
    return 100.0 * roofline.bound_s(*need) / seconds

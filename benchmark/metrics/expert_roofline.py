"""Kernel 8's share of its roofline, in percent: the least time of the
traced call's expert work (the chosen routed experts and the shared one at
every MoE layer of every decode step: the traffic driver's `expert_least_s`) over
the device time of kernel 8's two launches (`moe_gate_up_kernel`,
`moe_down_kernel`) in the traced session's top device operations. None
where the kernel is not among them, or nothing was traced."""

KERNELS = ("moe_gate_up_kernel", "moe_down_kernel")


def read(ctx):
    tr, per_call = ctx["trace"], ctx["summary"].get("expert_least_s")
    units = ctx.get("traced_units")
    if tr is None or not per_call or not units:
        return None
    ops = tr["breakdown"]["device_ops"]
    found = {k: sum(s for name, s in ops if k in name) for k in KERNELS}
    if not all(found.values()):
        return None
    return 100.0 * sum(per_call[k] for k in units) / sum(found.values())

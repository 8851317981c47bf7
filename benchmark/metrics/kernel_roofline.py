"""The kernels' share of their roofline, in percent: the least time of the
work in the traced units (whole `asr` calls or feeds; roofline.py, each
piece bound by its operations or its bytes) over the device's busy time
while they ran (the union of the kernels' intervals in the traced session).
It reads the same work whatever kernels implement it, glue kernels
included."""


def read(ctx):
    tr, least = ctx["trace"], ctx["traced_least_s"]
    if tr is None or not least or tr["busy_s"] <= 0:
        return None
    return 100.0 * least / tr["busy_s"]

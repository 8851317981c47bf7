"""Stream time of a prefill's expert products, in ms: the sum of the
traced units' `moe.prefill` device spans (one per MoE layer of a prefill:
routing's sort, the grouped products, the scatter back) over the prefills
they ran (`decode.prefill` spans). Like `prefill_ms`, it holds the
launches. A span whose end the stream had not reached is left out. None
where the port records no such span."""

from benchmark import spans


def read(ctx):
    recs = spans.records()
    if not recs:
        return None
    moe = [t for t in (r.device_seconds() for r in spans.spans(recs, "moe.prefill"))
           if t is not None]
    prefills = len(spans.spans(recs, "decode.prefill"))
    if not moe or not prefills:
        return None
    return 1e3 * sum(moe) / prefills

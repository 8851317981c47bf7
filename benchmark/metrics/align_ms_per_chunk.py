"""The align worker's time in the aligner per aligned chunk, in ms: in the
traced units (whole `asr` calls), the host time of the `align.encode` spans
(the aligner's encodes: `pre_encode` and `align()`'s own) and of the
`align.decode` spans (its readouts, each with its wait for the card, which
shares its stream with the decode) over the alignments the units' calls
served. The worker runs beside the decode: this is what the third stage
asks of a chunk, not what it adds to a call's wall (`rtf` holds that)."""

from benchmark import spans


def read(ctx):
    recs = spans.records()
    per_call, units = ctx["summary"].get("aligned_chunks"), ctx.get("traced_units")
    if not recs or not per_call or not units:
        return None
    n = sum(per_call[k] for k in units)
    if not n:
        return None
    t = sum(r.seconds for name in ("align.encode", "align.decode")
            for r in spans.spans(recs, name))
    return 1e3 * t / n if t > 0 else None

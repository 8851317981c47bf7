"""Host time to queue one decode step, in ms: the `decode.dispatch` spans
(`Generator.decode_block_dispatch`) over the steps they queued (counter
`decode.steps`), in the traced units. The rest of a step's time on the
host is the wait for its block (`decode.collect`)."""

from benchmark import spans


def read(ctx):
    recs = spans.records()
    if not recs:
        return None
    steps = spans.counted(recs, "decode.steps")
    if not steps:
        return None
    return 1e3 * sum(r.seconds for r in spans.spans(recs, "decode.dispatch")) / steps

"""Stream time of one audio encode, in ms: the mean over the traced units'
`engine.encode` device spans of the elapsed time between each span's two
CUDA events. That is the time the stream took to pass the encode, launches
included: while the host launches slower than the card runs, it reads the
host's launch time, and a faster encoder kernel moves it only once the
launches outrun the card. A span whose end the stream had not reached is
left out."""

from benchmark import spans


def read(ctx):
    recs = spans.records()
    times = [t for t in (r.device_seconds() for r in spans.spans(recs or [], "engine.encode"))
             if t is not None]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)

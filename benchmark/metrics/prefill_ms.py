"""Stream time of a feed's prompt prefill, in ms: per traced feed (a
`stream.feed` span and its request id), the sum over its `decode.prefill`
device spans of the elapsed time between each span's two CUDA events; the
mean over the feeds. Like `encode_ms`, it holds the launches: while the
host launches slower than the card runs, it reads the host's launch time.
A span whose end the stream had not reached is left out."""

from benchmark import spans


def read(ctx):
    recs = spans.records()
    feeds = spans.spans(recs, "stream.feed") if recs else []
    if not feeds:
        return None
    prefills = spans.spans(recs, "decode.prefill")
    per_feed = [sum(t for t in (p.device_seconds() for p in prefills if p.request == f.request)
                    if t is not None)
                for f in feeds]
    return 1e3 * sum(per_feed) / len(per_feed)

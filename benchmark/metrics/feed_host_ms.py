"""The host's own work in a feed, in ms: per traced feed, its `stream.feed`
span less the topmost `engine.encode` and `decode.*` spans inside it (the
encode's and the decode's queueing and the wait for the block), so what is
left is the prompt, the prefix and its re-encode, the token and text work
and the parse; the mean over the feeds."""

from benchmark import spans


def _encode_or_decode(name: str) -> bool:
    return name == "engine.encode" or name.startswith("decode.")


def read(ctx):
    recs = spans.records()
    feeds = spans.spans(recs, "stream.feed") if recs else []
    if not feeds:
        return None
    own = [f.seconds - sum(r.seconds for r in spans.top_descendants(recs, f, _encode_or_decode))
           for f in feeds]
    return 1e3 * sum(own) / len(own)

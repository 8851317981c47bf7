"""Share of the decode steps replayed as a captured CUDA graph, in the
traced units: the counter `decode.graph_replays` over `decode.steps`
(`Generator.decode_block_dispatch`). 1.0 where every step of the units was
replayed; below it where a step ran eagerly (a key captured inside the
units runs its first step eagerly, and a profiler session captures none).
None where the port counts no replays."""

from benchmark import spans


def read(ctx):
    recs = spans.records()
    if not recs:
        return None
    steps = spans.counted(recs, "decode.steps")
    if not steps or not any(r.name == "decode.graph_replays" for r in recs):
        return None
    return spans.counted(recs, "decode.graph_replays") / steps

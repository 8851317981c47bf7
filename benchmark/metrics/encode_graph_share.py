"""Share of the audio encodes replayed as a captured CUDA graph, in the
traced units: the counter `encode.graph_replays` over `encode.calls`
(`EncoderRunner.encode`, on every runner: the engine's, the stream's and the
aligner's on its worker). 1.0 where every encode of the units was replayed;
below it where one ran eagerly (a key first met inside a profiler session
runs eagerly and captures nothing). None where the port counts no encodes."""

from benchmark import spans


def read(ctx):
    recs = spans.records()
    if not recs:
        return None
    calls = spans.counted(recs, "encode.calls")
    if not calls:
        return None
    return spans.counted(recs, "encode.graph_replays") / calls

"""The streaming transcriber's warm-up of every encoder bucket and prompt
length, in seconds: the `stream.prewarm` span's total, always on."""

from benchmark import spans


def read(ctx):
    return spans.total("stream.prewarm")

"""The engine's set-up, in seconds: the `engine.init` span's total
(`QwenASREngine.__init__`; one engine a run), always on."""

from benchmark import spans


def read(ctx):
    return spans.total("engine.init")

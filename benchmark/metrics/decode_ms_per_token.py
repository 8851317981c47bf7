"""Host time of the decode per generated token, in ms: the engine's
decode time (queueing a chunk's blocks plus the wait for their tokens)
over the tokens generated, summed over the window."""


def read(ctx):
    s = ctx["summary"]
    if not s.get("decode_tokens"):
        return None
    return 1e3 * s["decode_time_s"] / s["decode_tokens"]

"""Share of the offline calls' wall time outside the decode (encode,
prefill, prompt assembly), in percent:
1 - sum(decode time) / sum(call wall)."""


def read(ctx):
    s = ctx["summary"]
    if not s.get("calls_wall_s"):
        return None
    return 100.0 * (1.0 - s["decode_time_s"] / s["calls_wall_s"])

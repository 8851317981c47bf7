"""Share of the traced units (whole `asr` calls or feeds) in which no
kernel ran on the card, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

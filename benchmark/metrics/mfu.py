"""The whole step's share of the card's peak: the least time of the work
the window completed (roofline.py: each piece bound by its operations or
its bytes) over the window's wall time, in percent."""


def read(ctx):
    window = ctx["summary"].get("window_s")
    if not window or not ctx["least_s"]:
        return None
    return 100.0 * ctx["least_s"] / window

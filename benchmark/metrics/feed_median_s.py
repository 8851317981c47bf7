"""Median time of a streaming feed, in seconds, beside its 90th percentile."""

import statistics


def read(ctx):
    lat = ctx["summary"].get("feed_latencies")
    return statistics.median(lat) if lat else None

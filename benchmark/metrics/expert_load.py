"""How unevenly a prefill's rows fall on the routed experts: the mean over
the traced units' MoE layers of the busiest expert's rows over the mean
expert's, from the port's counters `moe.rows` (rows routed in a layer of
a prefill) and `moe.rows_hottest` (those of its busiest expert), one count
of each per MoE layer and prefill: E * sum(hottest) / sum(rows), E the
routed experts (the traffic driver's `moe_experts`); every layer of a prompt
routes the same rows. 1.0 is an even load. None where the port counts no
routing."""

from benchmark import spans


def read(ctx):
    recs = spans.records()
    experts = ctx["summary"].get("moe_experts")
    if not recs or not experts:
        return None
    rows = spans.counted(recs, "moe.rows")
    if not rows:
        return None
    return experts * spans.counted(recs, "moe.rows_hottest") / rows

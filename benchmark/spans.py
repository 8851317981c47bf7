"""The port's tracer (`qwen3_asr_gguf_tpu_torch.utils.profiling`) as the
readers of its per-layer metrics see it. Recording is on while a
`torch.profiler` session is active, so the records are those of the traced
run's session: its whole units (the file cell's call, the stream cell's
feeds), and nothing of set-up or warm-up. A port without the tracer (no
`records` in that module) gives None everywhere, and so do its readers."""

from __future__ import annotations


def _module():
    try:
        from qwen3_asr_gguf_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") and hasattr(profiling, "TRACER") else None


def records() -> list | None:
    """The records kept so far, or None without the tracer."""
    mod = _module()
    return None if mod is None else mod.records()


def total(name: str) -> float | None:
    """The always-on total of span `name` in seconds, or None where no such
    span has ended (or there is no tracer)."""
    mod = _module()
    if mod is None or name not in mod.TRACER.totals:
        return None
    return mod.TRACER.totals[name]


def spans(recs: list, name: str) -> list:
    return [r for r in recs if r.name == name and r.n is None]


def counted(recs: list, name: str) -> int:
    return sum(r.n for r in recs if r.name == name and r.n is not None)


def top_descendants(recs: list, root, match) -> list:
    """The spans under `root` whose name satisfies `match` and that lie
    under no other such span below `root`."""
    by_id = {r.id: r for r in recs}
    out = []
    for r in recs:
        if r.n is not None or not match(r.name):
            continue
        up, top = by_id.get(r.parent), True
        while up is not None and up is not root:
            if match(up.name):
                top = False
            up = by_id.get(up.parent)
        if up is root and top:
            out.append(r)
    return out

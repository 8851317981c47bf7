"""The prompts the reference runs, worked out from the audio and from the
tokens a run served, by the Qwen3-ASR chat protocol:

    <|im_start|>system\\n{context}<|im_end|><|im_start|>user\\n<|audio_start|>
    AUDIO <|audio_end|><|im_end|><|im_start|>assistant\\nlanguage {L}<asr_text>
    {carried text} {served tokens}

A job is {"parts": [("ids", [...]) | ("audio", samples, rows)], "served": [...]}:
the reference encodes each audio part (attention among all the outputs of
`samples`) and keeps its first `rows` outputs, and reads its logits at
every served token.
"""

from __future__ import annotations

import numpy as np

from .model import HOP, encoder_tokens

SR = 16_000


def _parts(tok, ids: dict, language: str, context: str = "") -> tuple[list, list]:
    """(header through <|audio_start|>, template from <|audio_end|> through <asr_text>)."""
    enc = tok.encode
    header = ([ids["im_start"]] + enc(f"system\n{context or 'You are a helpful assistant.'}")
              + [ids["im_end"], ids["im_start"]] + enc("user\n") + [ids["audio_start"]])
    template = ([ids["audio_end"], ids["im_end"], ids["im_start"]]
                + enc(f"assistant\nlanguage {language}") + [ids["asr_text"]])
    return header, template


def rows_of(samples: int) -> int:
    return encoder_tokens(samples // HOP)


def file_jobs(tok, ids: dict, clip: np.ndarray, chunk_s: float, chunks: list, language: str,
              n_ctx: int, max_new: int) -> list[dict]:
    """One job per chunk of an offline call: fixed `chunk_s` chunks, each
    zero-padded to the full chunk; chunk i > 0 carries chunk i-1's audio
    (all its rows) and its stable tokens after the template (the oldest
    dropped if prompt and generation headroom would pass `n_ctx`).
    `chunks[i]` are chunk i's stable tokens as served."""
    n = int(chunk_s * SR)
    header, template = _parts(tok, ids, language)
    a_full = rows_of(n)
    jobs = []
    for i, served in enumerate(chunks):
        cur = np.zeros(n, np.float32)
        piece = clip[i * n:(i + 1) * n]
        cur[: len(piece)] = piece
        parts = [("ids", header)]
        carried = []
        if i > 0:
            prev = np.zeros(n, np.float32)
            prev[:] = clip[(i - 1) * n:i * n]
            parts.append(("audio", prev, a_full))
            carried = list(chunks[i - 1])
        parts.append(("audio", cur, rows_of(len(piece))))
        fixed = len(header) + a_full * (i > 0) + rows_of(len(piece)) + len(template)
        over = fixed + len(carried) - (n_ctx - min(max_new, 256))
        if over > 0:
            carried = carried[over:] if over < len(carried) else []
        parts.append(("ids", template + carried))
        jobs.append({"parts": parts, "served": list(served)})
    return jobs


def stream_jobs(tok, ids: dict, pcm: np.ndarray, chunk_s: float, feeds: list, language: str,
                n_ctx: int, max_new: int, unfixed_chunks: int, unfixed_tokens: int) -> list[dict]:
    """One job per feed of a live session: feed k (1-based) decodes the
    first k chunks of `pcm` with no carried text for k < `unfixed_chunks`,
    and after that with the text of the previous feed's tokens less their
    last `unfixed_tokens` (a trailing partial character dropped), as tokens
    again. `feeds[k - 1]` is the session's token list after feed k: the
    carried tokens and then the served ones. A feed whose list does not
    start with the carried tokens gets served None (a mismatch)."""
    n = int(chunk_s * SR)
    header, template = _parts(tok, ids, language)
    headroom = min(max_new, 256)
    jobs, prev = [], []
    for k, after in enumerate(feeds, start=1):
        audio = pcm[: k * n]
        rows = rows_of(len(audio))
        prefix = ""
        if k >= unfixed_chunks:
            keep = prev[:-unfixed_tokens] if unfixed_tokens else prev
            prefix = tok.decode(keep, skip_special=False).rstrip("�") if keep else ""
        carried = tok.encode(prefix) if prefix else []
        budget = max(n_ctx - headroom - len(header) - len(template) - rows, 0)
        kept = carried
        if len(carried) > budget:
            tail = carried[len(carried) - budget:]
            text = tok.decode(tail, skip_special=False).lstrip("�") if tail else ""
            kept = tok.encode(text) if text else []
        after = list(after)
        served = after[len(carried):] if after[: len(carried)] == carried else None
        jobs.append({"parts": [("ids", header), ("audio", audio, rows), ("ids", template + kept)],
                     "served": served})
        prev = after
    return jobs

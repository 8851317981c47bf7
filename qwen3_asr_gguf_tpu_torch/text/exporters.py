"""Result exporters: SRT / VTT / JSON / TXT.

Behavior mirrors the reference exporters (qwen_asr_gguf/inference/
exporters.py:10-119): SRT lines split on CJK/ASCII sentence punctuation or
max_chars overflow, trailing punctuation stripped, Chinese ITN applied;
TXT applies ITN then newline-after-punctuation formatting. SRT/VTT
composition is implemented here directly (no external srt dependency).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import List, Optional

from ..schema import ForcedAlignItem, TranscribeResult
from .itn import chinese_to_num as itn

_SPLIT_RE = re.compile(r"[，。？！、\n]|[,.?!]\s*")
_TRAIL_PUNCT = "，。？！：、,.?!"


@dataclass
class _Cue:
    index: int
    start: float
    end: float
    content: str


def _fmt_srt_time(seconds: float) -> str:
    ms = int(round(max(seconds, 0.0) * 1000))
    h, rem = divmod(ms, 3600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def _fmt_vtt_time(seconds: float) -> str:
    return _fmt_srt_time(seconds).replace(",", ".")


def _build_cues(items: List[ForcedAlignItem], max_chars: int = 40) -> List[_Cue]:
    cues: List[_Cue] = []
    texts: List[str] = []
    start: Optional[float] = None
    for item in items:
        if start is None:
            start = item.start_time
        texts.append(item.text)
        content = "".join(texts)
        if _SPLIT_RE.search(item.text) or len(content) >= max_chars:
            stripped = content.strip().rstrip(_TRAIL_PUNCT)
            if stripped:
                cues.append(_Cue(len(cues) + 1, start, item.end_time, itn(stripped)))
            texts, start = [], None
    if texts:
        stripped = "".join(texts).strip().rstrip(_TRAIL_PUNCT)
        if stripped:
            cues.append(_Cue(len(cues) + 1, start or 0.0, items[-1].end_time, itn(stripped)))
    return cues


def alignment_to_srt(items: Optional[List[ForcedAlignItem]], max_chars: int = 40) -> str:
    if not items:
        return ""
    blocks = [
        f"{c.index}\n{_fmt_srt_time(c.start)} --> {_fmt_srt_time(c.end)}\n{c.content}\n"
        for c in _build_cues(items, max_chars)
    ]
    return "\n".join(blocks)


def alignment_to_vtt(items: Optional[List[ForcedAlignItem]], max_chars: int = 40) -> str:
    if not items:
        return "WEBVTT\n"
    blocks = [
        f"{_fmt_vtt_time(c.start)} --> {_fmt_vtt_time(c.end)}\n{c.content}\n"
        for c in _build_cues(items, max_chars)
    ]
    return "WEBVTT\n\n" + "\n".join(blocks)


def srt_to_vtt(srt_text: str) -> str:
    """Convert SRT content to VTT (reference serve_openai_gguf.py:103-109)."""
    body = re.sub(
        r"(\d{2}:\d{2}:\d{2}),(\d{3})", r"\1.\2", srt_text
    )
    body = re.sub(r"^\d+\s*\n", "", body, flags=re.MULTILINE)
    return "WEBVTT\n\n" + body.strip() + ("\n" if body.strip() else "")


def alignment_to_json(items: Optional[List[ForcedAlignItem]]) -> List[dict]:
    if not items:
        return []
    return [
        {"text": it.text, "start": round(it.start_time, 3), "end": round(it.end_time, 3)}
        for it in items
    ]


def format_txt(text: str) -> str:
    """ITN + newline after sentence punctuation (reference exporters.py:108-115)."""
    out = itn(text)
    out = re.sub(r"([，。？！：])", r"\1\n", out)
    out = re.sub(r"(?<=[a-zA-Z])([,\.] )", r"\1\n", out)
    return out


def export_to_srt(path: str, result: TranscribeResult) -> None:
    content = alignment_to_srt(result.alignment.items) if result.alignment else ""
    with open(path, "w", encoding="utf-8") as f:
        f.write(content)


def export_to_vtt(path: str, result: TranscribeResult) -> None:
    content = alignment_to_vtt(result.alignment.items) if result.alignment else "WEBVTT\n"
    with open(path, "w", encoding="utf-8") as f:
        f.write(content)


def export_to_json(path: str, result: TranscribeResult) -> None:
    data = alignment_to_json(result.alignment.items) if result.alignment else []
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=2)


def export_to_txt(path: str, result: TranscribeResult) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(format_txt(result.text))

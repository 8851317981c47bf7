"""ASR output-protocol parsing and repetition scrubbing.

The model emits ``language <Lang><asr_text><transcript>`` (or plain text
when the user forces a language). Semantics follow the official package
(reference qwen_asr/inference/utils.py:335-497): repetition collapse of
>threshold char/pattern repeats, the "language none" silence convention,
and consecutive-dedup language merging.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..utils.languages import normalize_language_name

ASR_TEXT_TAG = "<asr_text>"
_LANG_PREFIX = "language "


def collapse_repetitions(text: str, threshold: int = 20, max_pattern_len: int = 20) -> str:
    """Collapse runs of a repeated char or short pattern down to one copy.

    A run qualifies when a unit of length k (1..max_pattern_len) repeats at
    least `threshold` times back-to-back (reference
    detect_and_fix_repetitions, utils.py:335-400).
    """
    # single characters first
    out = []
    i = 0
    n = len(text)
    while i < n:
        j = i
        while j < n and text[j] == text[i]:
            j += 1
        run = j - i
        out.append(text[i] if run > threshold else text[i:j])
        i = j
    text = "".join(out)

    # multi-char patterns
    def scrub(s: str) -> str:
        n = len(s)
        if n < threshold * 2:
            return s
        i = 0
        acc = []
        while i <= n - threshold * 2:
            for k in range(1, max_pattern_len + 1):
                if i + k * threshold > n:
                    break
                unit = s[i : i + k]
                if all(s[i + r * k : i + (r + 1) * k] == unit for r in range(1, threshold)):
                    end = i + threshold * k
                    while end + k <= n and s[end : end + k] == unit:
                        end += k
                    return "".join(acc) + unit + scrub(s[end:])
            acc.append(s[i])
            i += 1
        return "".join(acc) + s[i:]

    return scrub(text)


def parse_asr_output(raw: str, user_language: Optional[str] = None) -> Tuple[str, str]:
    """Parse raw model output into (language, text).

    - ``language X<asr_text>body`` -> (X normalized, body)
    - forced user_language       -> (user_language, whole output)
    - ``language none``          -> silence: ("", "") unless body non-empty
    - no tag                     -> ("", whole output)
    """
    if raw is None:
        return "", ""
    s = str(raw).strip()
    if not s:
        return "", ""
    s = collapse_repetitions(s)

    if user_language:
        return user_language, s

    if ASR_TEXT_TAG not in s:
        return "", s.strip()

    meta, body = s.split(ASR_TEXT_TAG, 1)
    body = body.strip()
    if "language none" in meta.lower():
        return "", body  # "" body = silence

    lang = ""
    for line in meta.splitlines():
        line = line.strip()
        if line.lower().startswith(_LANG_PREFIX):
            val = line[len(_LANG_PREFIX):].strip()
            if val:
                try:
                    lang = normalize_language_name(val)
                except ValueError:
                    lang = ""
            break
    return lang, body


def merge_languages(langs: List[str]) -> str:
    """Order-preserving merge dropping empties and consecutive duplicates."""
    out: List[str] = []
    prev = None
    for x in langs:
        x = (x or "").strip()
        if not x or x == prev:
            prev = x or prev
            continue
        out.append(x)
        prev = x
    return ",".join(out)

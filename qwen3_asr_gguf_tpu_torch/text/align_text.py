"""Forced-aligner text processing.

Host-side algorithms matching the reference AlignerProcessor
(qwen_asr_gguf/inference/aligner.py:17-227):

- language-aware word tokenization (CJK per-char; whitespace languages by
  word; Korean via a dependency-free LTokenizer over a caller-supplied
  L-dictionary — see `tokenize_korean` — matching the reference's
  soynlp+dict path; Japanese degrades to per-char without optional nagisa,
  same as the reference's ImportError fallback);
- LIS-based monotonic timestamp repair with neighbor-fill (<=2 anomalies)
  or linear interpolation (>2);
- reconciliation of punctuation/whitespace back into the aligned timeline
  with borrowed timestamps.
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional, Sequence

from ..schema import ForcedAlignItem


def is_kept_char(ch: str) -> bool:
    if ch == "'":
        return True
    cat = unicodedata.category(ch)
    return cat.startswith("L") or cat.startswith("N")


def clean_token(token: str) -> str:
    return "".join(ch for ch in token if is_kept_char(ch))


def is_cjk_char(ch: str) -> bool:
    code = ord(ch)
    return (
        0x4E00 <= code <= 0x9FFF or 0x3400 <= code <= 0x4DBF
        or 0x20000 <= code <= 0x2A6DF or 0x2A700 <= code <= 0x2B73F
        or 0x2B740 <= code <= 0x2B81F or 0x2B820 <= code <= 0x2CEAF
        or 0xF900 <= code <= 0xFAFF
    )


def tokenize_general(text: str) -> List[str]:
    """Whitespace split + per-char CJK split (covers zh/en/mixed/most)."""
    tokens: List[str] = []
    for seg in text.split():
        cleaned = clean_token(seg)
        if not cleaned:
            continue
        buf: List[str] = []
        for ch in cleaned:
            if is_cjk_char(ch):
                if buf:
                    tokens.append("".join(buf))
                    buf = []
                tokens.append(ch)
            else:
                buf.append(ch)
        if buf:
            tokens.append("".join(buf))
    return tokens


def _tokenize_chars(text: str) -> List[str]:
    return [ch for ch in text if is_kept_char(ch)]


def _is_hangul(ch: str) -> bool:
    code = ord(ch)
    return 0xAC00 <= code <= 0xD7A3 or 0x1100 <= code <= 0x11FF or 0x3130 <= code <= 0x318F


def tokenize_korean(text: str, scores: Optional[dict] = None) -> List[str]:
    """LTokenizer-style Korean segmentation without the soynlp dependency.

    The reference builds soynlp's LTokenizer over a bundled frequency dict
    with every word scored 1.0 (aligner.py:19-30, 58-69); with uniform
    scores that algorithm reduces to: per whitespace eojeol, split off the
    longest prefix found in the dictionary as L, keep the remainder as R.
    `scores` maps word -> score (only membership matters at uniform scores).
    """
    if not scores:
        toks = tokenize_general(text)
        return toks if toks else _tokenize_chars(text)
    tokens: List[str] = []
    for eojeol in text.split():
        cleaned = clean_token(eojeol)
        if not cleaned:
            continue
        # soynlp picks the (L, R) split maximizing (score(L), len(L));
        # all-zero scores leave the eojeol whole
        n = len(cleaned)
        best = max(range(1, n + 1), key=lambda i: (scores.get(cleaned[:i], 0.0), i))
        tokens.append(cleaned[:best])
        if best < n:
            tokens.append(cleaned[best:])
    return tokens if tokens else _tokenize_chars(text)


def korean_scores_from_vocab(vocab_words) -> dict:
    """Build an L-dictionary from an iterable of words/subwords (e.g. the
    model's BPE vocabulary decoded to text): all-Hangul entries of length
    >= 2 score 1.0. A standalone stand-in for the reference's bundled
    korean_dict_jieba.dict — every deployment ships the model tokenizer,
    whose Korean BPE merges are exactly the high-frequency word prefixes."""
    scores: dict[str, float] = {}
    for w in vocab_words:
        w = w.strip()
        if len(w) >= 2 and all(_is_hangul(ch) for ch in w):
            scores[w] = 1.0
    return scores


def _jp_script(ch: str) -> str:
    code = ord(ch)
    if 0x30A0 <= code <= 0x30FF or code == 0x30FC or 0x31F0 <= code <= 0x31FF:
        return "katakana"  # incl. prolonged-sound mark
    if 0x3040 <= code <= 0x309F:
        return "hiragana"
    if is_cjk_char(ch):
        return "kanji"
    return "latin"  # latin letters / digits / other kept chars


def tokenize_japanese(text: str) -> List[str]:
    """Dependency-free Japanese segmentation (nagisa fallback,
    reference aligner.py:88-97 uses the nagisa neural tagger).

    Script-run grouping: katakana runs (loanwords) and latin/digit runs
    stay whole — splitting them per character would scatter one spoken word
    over several timestamp slots — while kanji and hiragana stay per-char
    (the CJK convention the aligner is trained with for Chinese)."""
    tokens: List[str] = []
    run: List[str] = []
    run_kind = ""
    for ch in text:
        if not is_kept_char(ch):
            if run:
                tokens.append("".join(run))
                run, run_kind = [], ""
            continue
        kind = _jp_script(ch)
        if kind in ("katakana", "latin") and kind == run_kind:
            run.append(ch)
            continue
        if run:
            tokens.append("".join(run))
        run, run_kind = [ch], kind
        if kind in ("kanji", "hiragana"):
            tokens.append("".join(run))
            run, run_kind = [], ""
    if run:
        tokens.append("".join(run))
    return tokens


def tokenize(text: str, language: Optional[str] = None, ko_scores: Optional[dict] = None) -> List[str]:
    lang = str(language or "").lower()
    if lang == "japanese":
        try:
            import nagisa  # type: ignore

            return [t for w in nagisa.tagging(text).words if (t := clean_token(w))]
        except ImportError:
            return tokenize_japanese(text)
    if lang == "korean":
        return tokenize_korean(text, ko_scores)
    return tokenize_general(text)


def fix_timestamps(data: Sequence[int]) -> List[int]:
    """Repair non-monotonic timestamp predictions.

    Finds the longest non-decreasing subsequence; anomalies are replaced by
    the nearer normal neighbor (runs of <=2) or linearly interpolated
    between surrounding normals (reference aligner.py:99-136).
    """
    vals = [int(v) for v in data]
    n = len(vals)
    if n == 0:
        return []

    # O(n^2) LIS (non-decreasing) with parent links
    dp = [1] * n
    parent = [-1] * n
    for i in range(1, n):
        for j in range(i):
            if vals[j] <= vals[i] and dp[j] + 1 > dp[i]:
                dp[i] = dp[j] + 1
                parent[i] = j
    idx = dp.index(max(dp))
    normal = [False] * n
    while idx != -1:
        normal[idx] = True
        idx = parent[idx]

    out = vals[:]
    i = 0
    while i < n:
        if normal[i]:
            i += 1
            continue
        j = i
        while j < n and not normal[j]:
            j += 1
        left = next((out[k] for k in range(i - 1, -1, -1) if normal[k]), None)
        right = next((out[k] for k in range(j, n) if normal[k]), None)
        count = j - i
        if count <= 2:
            for k in range(i, j):
                if left is None:
                    out[k] = right  # type: ignore[assignment]
                elif right is None:
                    out[k] = left
                else:
                    out[k] = left if (k - i + 1) <= (j - k) else right
        else:
            if left is not None and right is not None:
                step = (right - left) / (count + 1)
                for k in range(i, j):
                    out[k] = int(left + step * (k - i + 1))
            else:
                fill = left if left is not None else right
                for k in range(i, j):
                    out[k] = fill  # type: ignore[assignment]
        i = j
    return [int(v) for v in out]


def find_token_indices(text: str, target: str, start_index: int) -> tuple[int, int]:
    """Smallest [start, end) span of `text` containing `target`'s chars in
    order, allowing non-kept chars in between (reference aligner.py:200-227)."""
    if not target:
        return -1, -1
    t_ptr = 0
    first = -1
    i = start_index
    n = len(text)
    while i < n:
        ch = text[i]
        if ch == target[t_ptr]:
            if t_ptr == 0:
                first = i
            t_ptr += 1
            if t_ptr == len(target):
                return first, i + 1
        elif is_kept_char(ch):
            if first != -1:
                i = first  # restart just past the failed anchor
                first = -1
                t_ptr = 0
        i += 1
    return -1, -1


def reconcile(original_text: str, items: List[ForcedAlignItem]) -> List[ForcedAlignItem]:
    """Re-insert punctuation/gap segments with borrowed timestamps
    (reference aligner.py:138-198)."""
    if not items:
        return (
            [ForcedAlignItem(text=original_text, start_time=0.0, end_time=0.0)]
            if original_text
            else []
        )

    out: List[ForcedAlignItem] = []
    ptr = 0
    last_ts = items[0].start_time
    for item in items:
        start, end = find_token_indices(original_text, item.text, ptr)
        if start == -1:
            out.append(item)  # degraded: keep as-is
            last_ts = item.end_time
            continue
        if start > ptr:
            gap = original_text[ptr:start]
            out.append(ForcedAlignItem(text=gap, start_time=last_ts, end_time=last_ts))
        out.append(
            ForcedAlignItem(
                text=original_text[start:end],
                start_time=item.start_time,
                end_time=item.end_time,
            )
        )
        ptr = end
        last_ts = item.end_time
    if ptr < len(original_text):
        out.append(
            ForcedAlignItem(text=original_text[ptr:], start_time=last_ts, end_time=last_ts)
        )
    return out

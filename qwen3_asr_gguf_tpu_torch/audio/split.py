"""Audio chunk splitting at low-energy boundaries.

Semantics follow the official package (reference qwen_asr/inference/
utils.py:246-332): long audio splits into <= `chunk_sec` pieces, with each
cut moved to the quietest 100 ms window within +/- `search_sec` of the
nominal boundary so words aren't cut mid-phoneme.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16_000


def _window_energy(audio: np.ndarray, start: int, win: int) -> float:
    seg = audio[start : start + win]
    if seg.size == 0:
        return np.inf
    return float(np.mean(seg.astype(np.float64) ** 2))


def find_low_energy_cut(
    audio: np.ndarray,
    target: int,
    *,
    search: int,
    win: int = SAMPLE_RATE // 10,  # 100 ms
) -> int:
    """Sample index of the quietest 100 ms window near `target`."""
    lo = max(0, target - search)
    hi = min(len(audio) - win, target + search)
    if hi <= lo:
        return target
    starts = np.arange(lo, hi, win // 2)
    energies = [_window_energy(audio, int(s), win) for s in starts]
    best = int(starts[int(np.argmin(energies))])
    return best + win // 2  # cut in the middle of the quiet window


def split_audio_into_chunks(
    audio: np.ndarray,
    chunk_sec: float = 1200.0,
    search_sec: float = 5.0,
    min_sec: float = 0.5,
) -> list[tuple[np.ndarray, float]]:
    """Split into (chunk, start_offset_sec) pairs at low-energy boundaries."""
    n = len(audio)
    chunk = int(chunk_sec * SAMPLE_RATE)
    search = int(search_sec * SAMPLE_RATE)
    if n <= chunk:
        return [(audio, 0.0)]
    out = []
    pos = 0
    while pos < n:
        # a tail within the search slack isn't worth its own fragment
        if n - pos <= chunk + search:
            out.append((audio[pos:], pos / SAMPLE_RATE))
            break
        cut = find_low_energy_cut(audio, pos + chunk, search=search)
        cut = max(pos + int(min_sec * SAMPLE_RATE), min(cut, n))
        out.append((audio[pos:cut], pos / SAMPLE_RATE))
        pos = cut
    return out

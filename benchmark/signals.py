"""Speech-like test audio from a seed: voiced syllables (a gliding
fundamental with falling harmonics) under a syllable-rate envelope, pauses
between phrases, and a little noise, at 16 kHz. The same (seed, index)
gives the same signal; only the content changes with the seed, never the
length.
"""

from __future__ import annotations

import numpy as np

SR = 16_000


def speech(seed: int, index: int, seconds: float) -> np.ndarray:
    rng = np.random.default_rng([seed, index])
    n = int(round(seconds * SR))
    # syllables of 0.12-0.35 s, a pause of 0.2-0.6 s after every 3-9 of them
    env = np.zeros(n, np.float32)
    pos, left = 0, int(rng.integers(3, 10))
    while pos < n:
        ln = int(rng.uniform(0.12, 0.35) * SR)
        w = np.hanning(ln).astype(np.float32) * rng.uniform(0.3, 1.0)
        env[pos:pos + ln] = w[: max(0, min(ln, n - pos))]
        pos += ln
        left -= 1
        if left == 0:
            pos += int(rng.uniform(0.2, 0.6) * SR)
            left = int(rng.integers(3, 10))
    t = np.arange(n) / SR
    f0 = (rng.uniform(100, 220) + 30 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t
                                              + rng.uniform(0, 2 * np.pi)))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(h * phase) / h for h in range(1, 6))
    noise = rng.standard_normal(n) * 0.01
    return (0.25 * env * voiced + noise).astype(np.float32)

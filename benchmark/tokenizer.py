"""Byte-level BPE tokenizer (Qwen2 family): the benchmark's frozen copy of
the port's `text/tokenizer.py`. It writes the synthetic vocabulary into the
checkpoint and builds the reference's prompts, so a later change to the
port changes neither.

GPT-2 byte-to-unicode mapping, Qwen2 pre-tokenization regex (the `re`
fallback where the `regex` module is missing, as in the port), ranked merge
loop, special-token splitting, byte-level decoding.
"""

from __future__ import annotations

from functools import lru_cache

try:
    import regex as _re  # supports \p{L} classes

    _HAS_REGEX = True
except ImportError:  # pragma: no cover
    import re as _re

    _HAS_REGEX = False

# Qwen2 pre-tokenizer pattern (llama.cpp LLAMA_VOCAB_PRE_TYPE_QWEN2)
_QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+"
    r"|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)
_FALLBACK_PATTERN = r"\S+|\s+"  # degraded mode without the regex module


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2 reversible byte <-> printable-unicode map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@lru_cache(maxsize=1)
def _unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in _bytes_to_unicode().items()}


# GGUF token_type values (ggml enum)
TOKTYPE_NORMAL = 1
TOKTYPE_UNKNOWN = 2
TOKTYPE_CONTROL = 3
TOKTYPE_USER_DEFINED = 4


class BPETokenizer:
    def __init__(
        self,
        tokens: list[str],
        merges: list[str],
        token_types: list[int] | None = None,
        eos_token_id: int | None = None,
        bos_token_id: int | None = None,
    ):
        self.tokens = tokens
        self.token_to_id_map: dict[str, int] = {t: i for i, t in enumerate(tokens)}
        self.merge_ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(merges):
            a, _, b = merge.partition(" ")
            self.merge_ranks[(a, b)] = rank
        types = token_types or [TOKTYPE_NORMAL] * len(tokens)
        self.special_tokens = {
            t: i for i, t in enumerate(tokens)
            if i < len(types) and types[i] in (TOKTYPE_CONTROL, TOKTYPE_USER_DEFINED)
        }
        self.eos_token_id = eos_token_id
        self.bos_token_id = bos_token_id
        self._pattern = _re.compile(_QWEN2_PATTERN if _HAS_REGEX else _FALLBACK_PATTERN)
        # longest-first special-token splitter
        if self.special_tokens:
            alts = sorted(self.special_tokens, key=len, reverse=True)
            self._special_re = _re.compile("|".join(_re.escape(t) for t in alts))
        else:
            self._special_re = None
        self._byte_enc = _bytes_to_unicode()
        self._byte_dec = _unicode_to_bytes()

    # -- loading -----------------------------------------------------------

    @classmethod
    def from_gguf_kv(cls, kv: dict) -> "BPETokenizer":
        tokens = list(kv["tokenizer.ggml.tokens"])
        merges = list(kv.get("tokenizer.ggml.merges", []))
        types = list(kv.get("tokenizer.ggml.token_type", [])) or None
        if types is not None:
            types = [int(t) for t in types]
        return cls(
            tokens, merges, types,
            eos_token_id=kv.get("tokenizer.ggml.eos_token_id"),
            bos_token_id=kv.get("tokenizer.ggml.bos_token_id"),
        )

    # -- encoding ----------------------------------------------------------

    def _bpe_word(self, word: str) -> list[str]:
        parts = list(word)
        if len(parts) < 2:
            return parts
        while True:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.merge_ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                return parts
            parts = parts[:best_i] + [parts[best_i] + parts[best_i + 1]] + parts[best_i + 2 :]

    def _encode_ordinary(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self._pattern.findall(text):
            mapped = "".join(self._byte_enc[b] for b in piece.encode("utf-8"))
            for part in self._bpe_word(mapped):
                idx = self.token_to_id_map.get(part)
                if idx is None:
                    # byte-fallback: emit per-char tokens where known
                    for ch in part:
                        ci = self.token_to_id_map.get(ch)
                        if ci is not None:
                            ids.append(ci)
                else:
                    ids.append(idx)
        return ids

    def encode(self, text: str, *, allow_special: bool = True) -> list[int]:
        if not text:
            return []
        if self._special_re is None or not allow_special:
            return self._encode_ordinary(text)
        ids: list[int] = []
        pos = 0
        for m in self._special_re.finditer(text):
            if m.start() > pos:
                ids.extend(self._encode_ordinary(text[pos : m.start()]))
            ids.append(self.special_tokens[m.group()])
            pos = m.end()
        if pos < len(text):
            ids.extend(self._encode_ordinary(text[pos:]))
        return ids

    # reference-compatible aliases (llama.py LlamaModel API)
    def tokenize(self, text: str) -> list[int]:
        return self.encode(text)

    def token_to_id(self, token: str) -> int:
        idx = self.token_to_id_map.get(token)
        if idx is None:
            raise KeyError(f"token {token!r} not in vocab")
        return idx

    # -- decoding ----------------------------------------------------------

    def token_to_bytes(self, token_id: int) -> bytes:
        """Raw UTF-8 bytes of one token (for incremental decoding)."""
        tok = self.tokens[token_id]
        if tok in self.special_tokens:
            return tok.encode("utf-8")
        dec = self._byte_dec
        try:
            return bytes(dec[ch] for ch in tok)
        except KeyError:
            return tok.encode("utf-8")

    def decode(self, ids: list[int], *, skip_special: bool = True) -> str:
        out = bytearray()
        for i in ids:
            tok = self.tokens[i]
            if skip_special and tok in self.special_tokens:
                continue
            out += self.token_to_bytes(i)
        return out.decode("utf-8", errors="replace")

    @property
    def n_vocab(self) -> int:
        return len(self.tokens)


def build_synthetic_tokenizer(vocab_size: int = 512) -> BPETokenizer:
    """Deterministic tiny tokenizer for tests/benchmarks without real vocab
    files: all 256 byte tokens + common special tokens + ascii merges, then
    single CJK characters as filler.

    CJK filler (not ``<unusedN>``) keeps a random-weight decoder's sampled
    output representative of the reference's benchmark workload — a Chinese
    transcript whose aligner words are single CJK characters (reference
    test_audio.txt; README.md:49 measures 50.2 s Chinese audio) — so the
    forced-alignment path in benchmarks sees realistic per-char word lists
    rather than latin ``unused123`` soup."""
    byte_enc = _bytes_to_unicode()
    tokens = [byte_enc[b] for b in range(256)]
    specials = [
        "<|im_start|>", "<|im_end|>", "<|endoftext|>", "<|audio_start|>",
        "<|audio_end|>", "<|audio_pad|>", "<asr_text>", "<timestamp>",
    ]
    tokens.extend(specials)
    merges: list[str] = []
    # pair frequent ascii letters to exercise the merge loop
    for a in "etaoinshr":
        for b in "etaoinshr":
            if len(tokens) >= vocab_size:
                break
            merges.append(f"{a} {b}")
            tokens.append(a + b)
    # CJK unified ranges (BMP first, then extension B), then two-char
    # combinations once single chars run out (a 152k vocab outnumbers the
    # ~70k unified chars); two-char pieces still split per-char in the
    # aligner, like real multi-char CJK BPE merges do.
    # Pieces are stored BYTE-ENCODED with real merges so encode() round-
    # trips them to their own ids, like the actual Qwen3 BPE does for
    # common CJK characters (llama-vocab semantics) — the speculative-align
    # word table relies on that round trip (aligner.build_word_cls_table).
    cjk_ranges = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF))

    def _cjk():
        for lo, hi in cjk_ranges:
            for c in range(lo, hi + 1):
                yield chr(c)
        for a in range(0x4E00, 0x9FFF):
            for b in range(0x4E00, 0x4E00 + 40):
                yield chr(a) + chr(b)

    cjk = _cjk()
    merge_seen = set(merges)
    vocab_seen = set(tokens)
    while len(tokens) < vocab_size:
        piece = "".join(byte_enc[b] for b in next(cjk).encode("utf-8"))
        # left-to-right pair merges build the piece: (c1 c2), (c1c2 c3), ...
        # — shared prefixes (CJK bytes cluster by plane) dedupe naturally.
        # Intermediate pieces enter the vocab too (real BPE vocabs contain
        # every merge product; HF `tokenizers` refuses merges whose halves
        # are out-of-vocabulary), so tokens and merges are added per piece
        # atomically: a truncated final piece would orphan its merges
        new_toks = [piece[: i + 1] for i in range(1, len(piece))
                    if piece[: i + 1] not in vocab_seen]
        if len(tokens) + len(new_toks) > vocab_size:
            break
        acc = piece[0]
        for ch in piece[1:]:
            m = f"{acc} {ch}"
            if m not in merge_seen:
                merge_seen.add(m)
                merges.append(m)
            acc += ch
        for t in new_toks:
            vocab_seen.add(t)
            tokens.append(t)
    while len(tokens) < vocab_size:  # top up if the last piece didn't fit
        tokens.append(f"<unused{len(tokens)}>")
    types = [TOKTYPE_NORMAL] * 256 + [TOKTYPE_CONTROL] * len(specials)
    types += [TOKTYPE_NORMAL] * (len(tokens) - len(types))
    return BPETokenizer(tokens, merges, types, eos_token_id=tokens.index("<|endoftext|>"))

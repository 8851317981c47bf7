"""The plain reference of Qwen3-ForcedAligner in PyTorch, float32: the audio
tower and the Qwen3 decoder of `model.py`, with the LM head replaced by a
classifier of `classify_num` timestamp classes of 80 ms each. It prefills
one sequence with causal attention,

    <|audio_start|> AUDIO <|audio_end|> w1 <timestamp> <timestamp> w2 <timestamp> ...

and reads at each <timestamp> slot (a word's start, then its end) the best
of the first TIMESTAMP_CLASSES classes.

The words of a text are split as the aligner's text processor splits them
(`words`): on whitespace; each piece keeps its letters, digits and
apostrophes; a CJK character is a word of its own. A word's tokens are its
encoding by the checkpoint's tokenizer.

Weights at the aligner's stated "int8": every matrix of the encoder and the
decoder, and the class head, symmetric int8 with one scale per output row
(the row's largest magnitude over 127), fitted to the decoder's exact q4_k
values, the head's exact q6_k values and the encoder's bf16 values. At
"f32" (the CPU tests' precision) they are the checkpoint's values.
"""

from __future__ import annotations

import json
import unicodedata
from pathlib import Path

import numpy as np
import torch

from ..checkpoint import _is_cjk
from . import model, weights

TIMESTAMP_CLASSES = 4000
DECODER_MATRICES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                    "down_proj", "lm_head")


def _kept(ch: str) -> bool:
    return ch == "'" or unicodedata.category(ch)[0] in "LN"


def words(text: str) -> list[str]:
    out = []
    for piece in text.split():
        buf = ""
        for ch in filter(_kept, piece):
            if _is_cjk(ch):
                if buf:
                    out.append(buf)
                    buf = ""
                out.append(ch)
            else:
                buf += ch
        if buf:
            out.append(buf)
    return out


class Int8Control(model.Precision):
    """The control one step below the aligner's products that take int8
    activations (every matrix of the encoder, where `head` is None; the
    class head `head` in the decoder): int4 activations there, 32 to a
    scale (float8 at a width that is not whole groups); float8 (e4m3)
    everywhere else, a step below bf16."""

    def __init__(self, head: torch.Tensor | None = None):
        super().__init__("fp8")
        self.head = head

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if (self.head is None or w is self.head) and x.shape[-1] % 32 == 0:
            return model._int4(x) @ w.t()
        return super().mm(x, w)


def int8_rows(w: torch.Tensor) -> torch.Tensor:
    """w re-fitted to symmetric int8, one scale per row of its last axis."""
    s = w.abs().amax(-1, keepdim=True).clamp(min=1e-10) / 127.0
    return torch.clamp(torch.round(w / s), -127, 127) * s


class Aligner:
    """The aligner of checkpoint directory `d` (its `config.json` names the
    special tokens), `cfg` the configuration's "aligner" block, in float32
    on `device`, or with `control` the control: "fp8" (`model.Precision`:
    float8 activations and cache in every product) or "int4dec" (one step
    below each stated precision: `Int8Control`)."""

    def __init__(self, d: Path, cfg: dict, device, control: str | None = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if cfg["precision"] not in ("int8", "f32"):
            raise ValueError(f"the aligner's reference knows int8 and f32, not "
                             f"{cfg['precision']!r}")
        self.device = torch.device(device)
        self.a, self.t = cfg["model"]["audio"], cfg["model"]["text"]
        self.enc = weights.encoder(d, "f32", self.device)
        self.dec = weights.decoder(d / "qwen3_asr_llm.q4_k.gguf", self.t, "f32", self.device)
        if cfg["precision"] == "int8":
            for name in weights.ENC_INT4:
                self.enc[name] = int8_rows(self.enc[name])
            for name in DECODER_MATRICES:
                self.dec[name] = int8_rows(self.dec[name])
        self.filters = torch.from_numpy(np.load(d / "mel_filters.npy")).to(self.device)
        ids = json.loads((d / "config.json").read_text())
        self.start, self.end = ids["audio_start_token_id"], ids["audio_end_token_id"]
        self.ts = ids["timestamp_token_id"]
        self.window = min(TIMESTAMP_CLASSES, self.t["classify_num"])
        if control == "int4dec":
            self.enc_prec, self.dec_prec = Int8Control(), Int8Control(self.dec["lm_head"])
        else:
            self.enc_prec = self.dec_prec = model.Precision(control)

    def prompt(self, n_audio: int, word_tokens: list) -> tuple[list, list]:
        """(ids after the audio, from <|audio_end|> on; the <timestamp>
        slots' positions in the whole prompt)."""
        post, slots = [self.end], []
        for toks in word_tokens:
            post += toks
            for _ in range(2):
                slots.append(1 + n_audio + len(post))
                post.append(self.ts)
        return post, slots

    @torch.no_grad()
    def logits(self, samples: np.ndarray, n_audio: int, word_tokens: list) -> torch.Tensor:
        """[2 * len(word_tokens), classify_num]: the class logits at each
        <timestamp> slot of the prompt over the audio `samples` (its first
        `n_audio` encoder rows) and the words' tokens."""
        mel = model.log_mel(torch.as_tensor(samples, device=self.device), self.filters)
        audio = model.encode(self.enc, self.a, mel, self.enc_prec)[:n_audio]
        post, slots = self.prompt(n_audio, word_tokens)
        embed = self.dec["embed"]
        emb = torch.cat([embed[torch.as_tensor([self.start], device=self.device)], audio,
                         embed[torch.as_tensor(post, device=self.device)]])
        at = torch.as_tensor(slots, device=self.device)
        return model.decode_logits(self.dec, self.t, emb, at, self.dec_prec)

"""Offline transcription with word times: `engine_file`'s back-to-back
`QwenASREngine.asr` calls with the forced aligner on. The engine's align
worker aligns chunk i-1 while chunk i decodes, pre-encodes the next
window, and aligns chunk 0 and the last chunk speculatively behind their
decode blocks, as the engine does by default; a call returns once its
last chunk is aligned, so its wall holds the alignment that the decode
does not hide.

Params: engine_file's. The configuration's "aligner" block: the aligner's
model, weights seed, precision and n_ctx (its checkpoint in `aligner/`).
"""

from __future__ import annotations

import numpy as np

from benchmark import roofline, signals
from benchmark.reference import aligner, prompts
from benchmark.traffic.engine_file import Driver as FileDriver
from benchmark.traffic.engine_file import chunk_results

WARM_SEED = 2**31 + 13


def record_alignments(al, sink: list) -> None:
    """Record each alignment the engine serves, as its align worker takes it:
    an `align` (the key of its window and the text), or a speculative one
    that `spec_align_collect` took."""
    align, collect = al.align, al.spec_align_collect

    def align_rec(audio, text, *a, **k):
        res = align(audio, text, *a, **k)
        sink.append({"path": "align", "key": k.get("precomputed_key"), "text": text})
        return res

    def collect_rec(stable_tokens, text, *a, **k):
        res = collect(stable_tokens, text, *a, **k)
        if res is not None:
            sink.append({"path": "spec", "key": k.get("key"), "text": text})
        return res

    al.align, al.spec_align_collect = align_rec, collect_rec


class Driver(FileDriver):
    def engine_options(self) -> dict:
        from qwen3_asr_gguf_tpu_torch.schema import AlignerConfig

        al = self.cfg["aligner"]
        return {"enable_aligner": True, "align_config": AlignerConfig(
            model_dir=str(self.ckpt / "aligner"), encoder_fn="qwen3_asr_encoder.safetensors",
            llm_fn="qwen3_asr_llm.q4_k.gguf", n_ctx=al["n_ctx"], precision=al["precision"])}

    def setup(self) -> None:
        super().setup()
        self.served: list = []
        record_alignments(self.engine.aligner, self.served)  # joins the aligner's bring-up

    def warm(self) -> None:
        """Two calls: an align window starts where the previous chunk's
        words end, so a second clip meets more of the aligner's encoder
        buckets and prompt lengths."""
        super().warm()
        self._call(signals.speech(WARM_SEED, 0, self.p["clip_s"]))

    def _call(self, clip: np.ndarray) -> dict:
        del self.served[:]
        call = super()._call(clip)
        call["texts"] = [r.text for r in chunk_results(self.recs)]
        call["seq"] = self.engine._align_seq
        call["aligns"] = list(self.served)
        return call

    def _chunk_of(self, key) -> int:
        chunk = int(self.cfg["engine"]["chunk_size"] * signals.SR)
        return -(-key[2] // chunk) - 1

    def _missing(self, call: dict) -> list[int]:
        """Chunks of `call` with words to align and no alignment served."""
        done = {self._chunk_of(a["key"]) for a in call["aligns"] if a["key"] is not None}
        return [i for i, text in enumerate(call["texts"]) if aligner.words(text) and i not in done]

    def summary(self, window: float) -> dict:
        s = super().summary(window)
        s["failed"] = sum(1 for c in self.calls if self._missing(c))
        s["aligned_chunks"] = [len(c["aligns"]) for c in self.calls]
        return s

    def _word_tokens(self, text: str) -> list:
        tok = self._tok()
        return [tok.encode(w, allow_special=False) for w in aligner.words(text)]

    def works(self, units=None) -> list:
        """engine_file's pieces, and for each alignment served the aligner's
        encode of its window and its prefill with the class head at the
        slots, at the stated int8."""
        out = super().works(units)
        a, t = self.cfg["aligner"]["model"]["audio"], self.cfg["aligner"]["model"]["text"]
        for k in units if units is not None else range(len(self.calls)):
            for al in self.calls[k]["aligns"]:
                _, s, e = al["key"]
                n_audio = prompts.rows_of(e - s)
                words = self._word_tokens(al["text"])
                length = 2 + n_audio + sum(len(w) + 2 for w in words)
                windows = -(-((e - s) // 160) // a["n_window"])
                out.append(roofline.encode(a, n_audio, windows, weight_bytes=1.0, peak="int8"))
                out.append(roofline.classify_prefill(t, length, 2 * len(words), weight_bytes=1.0))
        return out

    def jobs(self, rng) -> list:
        """engine_file's jobs of the calls `picks` draws, and one "align" job
        for each chunk of theirs: its alignment as served (path, window key,
        text) with the chunk's stable tokens, or, where none was served for a
        chunk with words, a job that finds none."""
        tok = self._tok()
        out = []
        for k in self.picks(rng):
            call, clip = self.calls[k], self.clip(k)
            out += self._jobs_for(clip, call["chunks"], tok)
            for al in call["aligns"]:
                out.append({"kind": "align", "clip": clip, **al,
                            "tokens": call["chunks"][self._chunk_of(al["key"])]})
            out += [{"kind": "align", "clip": clip, "path": None, "key": None,
                     "text": call["texts"][i], "tokens": call["chunks"][i]}
                    for i in self._missing(call)]
        return out

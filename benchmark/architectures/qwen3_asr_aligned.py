"""Qwen3-ASR with Qwen3-ForcedAligner as the engine's third stage: the
configuration's "model" is the ASR model as `qwen3_asr` has it, and its
"aligner" block the aligner, with weights of its own seed.

- Checkpoint: the ASR model's directory as `qwen3_asr` writes it, and the
  aligner's beside it in `aligner/` (the same file names; its class head
  of `classify_num` rows not biased to any token).
- Taps: `qwen3_asr`'s first tokens, and `AlignTap`, the class the port's
  aligner reads at each <timestamp> slot and what rebuilds the prompt.
- Reference: `qwen3_asr`'s for the decoder's jobs; for each "align" job
  (one chunk's alignment as the engine served it) `reference/aligner.py`
  over the same window of audio and the chunk's words, worked out again
  from its text. The port's class at each slot is judged by its gap below
  the reference's best class in the same window of TIMESTAMP_CLASSES.
- Numbers: `qwen3_asr`'s, and `align_gap_widest`, `align_gap_mean`,
  `align_judged` (slots judged) and `align_mismatches` (a served alignment
  that the tap did not see, or whose window, prompt or classes are not
  what the reference works out).
"""

from __future__ import annotations

import json
import threading

import numpy as np
import torch

from benchmark import checkpoint as writer
from benchmark.architectures import qwen3_asr as asr
from benchmark.reference import aligner, check, prompts
from benchmark.tokenizer import build_synthetic_tokenizer

CONTROLS = ("fp8", "int4dec")
FIXED = {"prompt_mismatches": 0, "align_mismatches": 0}
ALIGNER_DIR = "aligner"
DECODER_FN = "qwen3_asr_llm.q4_k.gguf"


def write_aligner(d, model: dict, seed: int, device) -> None:
    d.mkdir(parents=True, exist_ok=True)
    tok = build_synthetic_tokenizer(model["text"]["vocab_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    writer.write_encoder(d / writer.ENCODER_FN, model["audio"], gen, device)
    writer.write_decoder(d / DECODER_FN, model["text"], tok, gen, device, None)
    (d / "config.json").write_text(json.dumps(writer.thinker_json(model, tok), indent=1))
    np.save(d / "mel_filters.npy", writer.mel_filterbank())


def checkpoint(cfg: dict, cache_root, device):
    def write(tmp):
        writer.write_model(tmp, cfg["model"], int(cfg["weights_seed"]), device)
        al = cfg["aligner"]
        write_aligner(tmp / ALIGNER_DIR, al["model"], int(al["weights_seed"]), device)

    return writer.ensure(cfg, cache_root, device, write=write,
                         keys=("model", "weights_seed", "aligner"))


class AlignTap:
    """What the port's aligner computed for each window it aligned: the
    class at each <timestamp> slot and what rebuilds the prompt. It wraps
    `SparseLogitsRunner.argmax_at` (`align()`'s readout: the prompt's ids
    and the classes come back to the host there) and `argmax_at_spec` (the
    speculative readout: a device copy of the block's tokens it reads and
    the device tensor of its classes, kept until the window has closed), and
    the aligner's `align`, `spec_align_start` and `spec_align_collect` for
    the key (call, window start, window end) that each serves and whether a
    speculative result was taken. Nothing is read back while the port runs.
    Installed before the engine is built, so that the aligner's bring-up
    thread finds it."""

    def __init__(self, device):
        self.recs: list = []
        self._local = threading.local()
        self._saved: list = []

    def install(self) -> None:
        from qwen3_asr_gguf_tpu_torch.runtime import aligner as port_aligner
        from qwen3_asr_gguf_tpu_torch.runtime import generate

        runner, fa = generate.SparseLogitsRunner, port_aligner.QwenForcedAligner
        recs, local = self.recs, self._local
        at, at_spec = runner.argmax_at, runner.argmax_at_spec

        def argmax_at(self_, ids, audio_mask, audio_embd, positions, limit):
            out = at(self_, ids, audio_mask, audio_embd, positions, limit)
            recs.append({"path": "align", "key": getattr(local, "key", None),
                         "ids": np.array(ids), "n_audio": int(np.sum(audio_mask)),
                         "classes": np.array(out)})
            return out

        def argmax_at_spec(self_, toks, cls_tab, audio_embd, n_audio, limit, special,
                           drop_last=0):
            out = at_spec(self_, toks, cls_tab, audio_embd, n_audio, limit, special,
                          drop_last=drop_last)
            if out is not None:
                recs.append({"path": "spec", "key": getattr(local, "key", None),
                             "toks": toks.clone(), "drop_last": int(drop_last),
                             "n_audio": int(n_audio), "out": out.dev})
            return out

        def keyed(fn, arg):
            def wrapped(self_, *a, **k):
                local.key = k.get(arg)
                try:
                    return fn(self_, *a, **k)
                finally:
                    local.key = None
            return wrapped

        collect = fa.spec_align_collect

        def spec_align_collect(self_, *a, **k):
            res = collect(self_, *a, **k)
            if res is not None:
                recs.append({"path": "taken", "key": k.get("key")})
            return res

        patches = [(runner, "argmax_at", argmax_at), (runner, "argmax_at_spec", argmax_at_spec),
                   (fa, "align", keyed(fa.align, "precomputed_key")),
                   (fa, "spec_align_start", keyed(fa.spec_align_start, "key")),
                   (fa, "spec_align_collect", spec_align_collect)]
        for owner, name, fn in patches:
            self._saved.append((owner, name, owner.__dict__[name]))
            setattr(owner, name, fn)

    def remove(self) -> None:
        while self._saved:
            owner, name, fn = self._saved.pop()
            setattr(owner, name, fn)

    def reset(self) -> None:
        del self.recs[:]

    def read(self) -> list:
        out = []
        for r in self.recs:
            r = dict(r)
            if r["path"] == "spec":
                r["toks"], r["out"] = r["toks"].cpu().numpy(), r["out"].cpu().numpy()
            out.append(r)
        return out

    def fill(self, jobs: list, record: list) -> str:
        """Each "align" job gets `port`: the record of its path and key (the
        last, as the one served), or None where there is none; a speculative
        one only where its result was taken."""
        taken = {r["key"] for r in record if r["path"] == "taken"}
        last = {(r["path"], r["key"]): r for r in record if r["path"] != "taken"}
        for job in jobs:
            if job.get("kind") == "align":
                r = last.get((job["path"], job["key"]))
                if r is not None and r["path"] == "spec" and r["key"] not in taken:
                    r = None
                job["port"] = r
        return f"{len(last)} alignments recorded"


def taps(device) -> list:
    return asr.taps(device) + [AlignTap(device)]


def port_alignment(port: dict, n_audio: int, post: list, n_words: int):
    """The port's classes where its alignment is the one the reference works
    out (the window's encoder rows, and the prompt: `post`, the ids from
    <|audio_end|> on, or for a speculative readout its count of words),
    else None."""
    if port["n_audio"] != n_audio:
        return None
    if port["path"] == "align":
        ids = port["ids"]
        if len(ids) != 1 + n_audio + len(post) or list(ids[1 + n_audio:]) != post:
            return None
        classes = port["classes"]
    else:
        if int(port["out"][-1]) != n_words:
            return None
        classes = port["out"][: 2 * n_words]
    return classes if len(classes) == 2 * n_words else None


class Judge:
    def __init__(self, ckpt, cfg: dict, device, control: str | None = None):
        self.device = torch.device(device)
        self.asr = asr.reference(ckpt, cfg, device, control)
        self.al = aligner.Aligner(ckpt / ALIGNER_DIR, cfg["aligner"], device, control)
        self.tok = check.tokenizer(ckpt / ALIGNER_DIR)

    def _words(self, job: dict) -> list:
        return [self.tok.encode(w, allow_special=False) for w in aligner.words(job["text"])]

    def _logits(self, job: dict, word_tokens: list) -> torch.Tensor:
        _, s, e = job["key"]
        return self.al.logits(job["clip"][s:e], prompts.rows_of(e - s), word_tokens)

    def _gaps(self, ref: torch.Tensor, classes) -> np.ndarray:
        c = torch.as_tensor(np.asarray(classes, dtype=np.int64), device=self.device)
        best = ref[:, : self.al.window].amax(-1)
        return (best - ref.gather(1, c[:, None])[:, 0]).cpu().numpy()

    def judge(self, job: dict, keep: bool = False) -> dict:
        if job.get("kind") != "align":
            return self.asr.judge(job, keep=keep)
        word_tokens = self._words(job)
        if not word_tokens:
            return {}
        if job["port"] is None or aligner.words(job["text"]) != aligner.words(
                self.tok.decode(job["tokens"], skip_special=False)):
            return {"align_mismatch": 1}
        _, s, e = job["key"]
        post, _ = self.al.prompt(prompts.rows_of(e - s), word_tokens)
        classes = port_alignment(job["port"], prompts.rows_of(e - s), post, len(word_tokens))
        if classes is None or not all(0 <= c < self.al.window for c in classes):
            return {"align_mismatch": 1}
        ref = self._logits(job, word_tokens)
        if keep:
            job["align_ref"] = ref
        return {"align_gaps": self._gaps(ref, classes)}

    def control(self, job: dict) -> dict:
        if job.get("kind") != "align":
            return self.asr.control(job)
        if "align_ref" not in job:
            return {}
        mine = self._logits(job, self._words(job))[:, : self.al.window].argmax(-1)
        return {"align_gaps": self._gaps(job["align_ref"], mine.cpu().numpy())}


def reference(ckpt, cfg: dict, device, control: str | None = None) -> Judge:
    return Judge(ckpt, cfg, device, control)


def numbers(results: list) -> dict:
    out = asr.numbers([r for r in results if "align_gaps" not in r
                          and "align_mismatch" not in r])
    gaps = [r["align_gaps"] for r in results if "align_gaps" in r]
    d = np.concatenate(gaps) if gaps else np.zeros(0)
    out.update({"align_gap_widest": float(d.max()) if len(d) else None,
                "align_gap_mean": float(d.mean()) if len(d) else None,
                "align_judged": int(len(d)),
                "align_mismatches": sum(r.get("align_mismatch", 0) for r in results)})
    return out

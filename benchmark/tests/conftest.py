"""Shared fixtures: a copy of the benchmark's directory in a temporary
root, with tiny configurations and cells added as files, run on the CPU on
the port's plain paths."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
TINY_AUDIO = {"num_mel_bins": 128, "d_model": 64, "encoder_layers": 2,
              "encoder_attention_heads": 4, "encoder_ffn_dim": 128,
              "downsample_hidden_size": 32, "output_dim": 48, "n_window": 100,
              "n_window_infer": 400, "conv_chunksize": 500, "max_source_positions": 1500,
              "activation": "gelu", "attention_mode": "full"}
TINY_TEXT = {"vocab_size": 512, "hidden_size": 48, "num_layers": 2, "num_heads": 4,
             "num_kv_heads": 2, "head_dim": 16, "intermediate_size": 96, "rms_norm_eps": 1e-6,
             "rope_theta": 5e6, "tie_word_embeddings": False, "classify_num": None}
# q4_k rows need widths in whole 256-blocks: the int4 engine's shapes
INT4_TEXT = dict(TINY_TEXT, hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64,
                 intermediate_size=512)
ENGINE = {"precision": "f32", "kv_cache_dtype": "bf16", "n_ctx": 512, "chunk_size": 2.0,
          "memory_num": 1, "kv_prefix_reuse": True, "pipelined_dispatch": True}

FILE_PARAMS = {"clip_s": 6.0, "language": "Chinese", "temperature": 0.4, "max_new_tokens": 8,
               "decode_block": 8, "sample_calls": 1}
STREAM_PARAMS = {"session_s": 8.0, "chunk_s": 2.0, "unfixed_chunk_num": 2,
                 "unfixed_token_num": 2, "language": "Chinese", "temperature": 0.4,
                 "max_new_tokens": 6, "decode_block": 6, "sample_feeds": 3, "warm_s": 4.0}

def config(name: str, text: dict = TINY_TEXT, precision: str = "f32") -> dict:
    audio = dict(TINY_AUDIO, output_dim=text["hidden_size"])
    return {"name": name, "source": "test", "weights_seed": 0, "assumed": [],
            "model": {"audio": audio, "text": text}, "engine": dict(ENGINE, precision=precision)}


class TinyBench:
    """A benchmark directory of its own: the real one's files plus those a
    test adds."""

    def __init__(self, root: Path):
        self.root = root
        self.bench = root / "benchmark"
        shutil.copytree(BENCH, self.bench,
                        ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
        self.contract = {"end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}

    def add_config(self, cfg: dict) -> None:
        (self.bench / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))

    def add_cell(self, name: str, config: str, driver: str, params: dict, e2e: str,
                 per_layer: list, gap: float = 1e-3, min_judged: int = 4) -> None:
        spec = {"config": config, "traffic": name, "driver": driver, "params": params,
                "limits": {"gap_widest": gap, "min_judged": min_judged},
                "trace": {"unit": 0, "units": 1}}
        (self.bench / "workloads" / f"{name}.json").write_text(json.dumps(spec))
        self.contract["end_to_end"].append({"name": e2e, "unit": "x", "workloads": [name]})
        self.contract["per_layer"] += [{"name": m, "unit": "x", "workloads": [name]}
                                       for m in per_layer]

    def run(self, name: str, trace: bool, seed: int = 2**31 + 5, seconds: float = 1.0) -> dict:
        from benchmark import harness

        return harness.run(self.bench, self.contract, name, seed, seconds, trace,
                           torch.device("cpu"), self.root / "cache", time.perf_counter(),
                           log=lambda _msg: None)


@pytest.fixture
def tiny(tmp_path, monkeypatch) -> TinyBench:
    torch.set_num_threads(1)
    return TinyBench(tmp_path)

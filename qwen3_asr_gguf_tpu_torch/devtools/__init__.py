"""Probes used while the tensor-core kernels (kernels 3 and 6) were designed;
each runs on a machine with a card, from the repository root:

    python -m qwen3_asr_gguf_tpu_torch.devtools.sweep_tiling [rows] [qmm]
    python -m qwen3_asr_gguf_tpu_torch.devtools.kernel_durations
    python -m qwen3_asr_gguf_tpu_torch.devtools.phase_clocks
    python -m qwen3_asr_gguf_tpu_torch.devtools.microbench

They time through `chip_smoke.py`'s helpers (cold weights, CUDA graph, CUDA
events) and print one line per case; PERF.md quotes them. `hf_checkpoint`
writes a random-weight checkpoint in the Hugging Face layout, the input of
the converter, for the tests and `chip_smoke.py`. Nothing here is on any path
of the port.
"""

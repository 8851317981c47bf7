"""Tensor, data and sequence parallelism on `torch.distributed` (counterpart
of `qwen3_asr_gguf_tpu/parallel/`): one process per rank, Megatron tiles cut
by `sharding`, the collectives of `collectives`, the fine-tuning step of
`train`, test worlds from `launch`, and `dryrun`, the multi-rank self-check."""

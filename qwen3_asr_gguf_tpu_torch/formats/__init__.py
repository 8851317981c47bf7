from . import quants
from .gguf import EmbeddingTable, GGUFReader, GGUFWriter, TensorInfo, get_token_embeddings_gguf

__all__ = [
    "quants",
    "GGUFReader",
    "GGUFWriter",
    "TensorInfo",
    "EmbeddingTable",
    "get_token_embeddings_gguf",
]

"""granite-34b code [dense] (arXiv:2405.04324; hf) — MQA (kv=1), 88 layers.

88L, d_model=6144, 48 heads (kv=1), d_ff=24576, vocab=49152.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152, gated_mlp=False, tie_embeddings=False,
    attention_impl="chunked", attn_chunk=2048,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    n_layers=5, d_model=128, n_heads=8, n_kv_heads=1, d_ff=256, vocab=512,
    tie_embeddings=False, attention_impl="dot", scan_chunk=16,
)
LR_SCHEDULE = "cosine"

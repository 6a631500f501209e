"""qwen2-1.5b [dense] (arXiv:2407.10671; hf) — GQA, QKV bias.

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    attention_impl="chunked", attn_chunk=2048,
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    n_layers=4, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192, vocab=512,
    qkv_bias=True, tie_embeddings=True, attention_impl="dot", scan_chunk=16,
)
LR_SCHEDULE = "cosine"

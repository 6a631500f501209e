"""phi3.5-moe-42b-a6.6b [moe] (hf:microsoft/Phi-3.5-MoE-instruct).

32L, d_model=4096, 32 heads (GQA kv=8, head_dim 128), d_ff=6400,
vocab=32064, 16 experts top-2, full attention.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, n_experts=16, moe_top_k=2, tie_embeddings=False,
    attention_impl="chunked", attn_chunk=2048,
)

SMOKE = ModelConfig(
    name="phi35-moe-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=512,
    n_experts=4, moe_top_k=2, tie_embeddings=False,
    attention_impl="dot", scan_chunk=16,
)
LR_SCHEDULE = "cosine"

"""mixtral-8x7b [moe] (arXiv:2401.04088; hf) — 8 experts top-2, SWA.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=32000,
sliding-window attention (4096): a rolling 4096-slot KV cache, so it
serves on the dense layout.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, n_experts=8, moe_top_k=2, attn_window=4096,
    rope_theta=1e6, tie_embeddings=False,
    attention_impl="chunked", attn_chunk=2048, grad_accum=4,
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_experts=4, moe_top_k=2, attn_window=16, tie_embeddings=False,
    attention_impl="dot", scan_chunk=16,
)
LR_SCHEDULE = "cosine"

"""llama-3.2-vision-90b [vlm] (hf:meta-llama/Llama-3.2-90B-Vision backbone).

100L, d_model=8192, 64 heads (GQA kv=8), d_ff=28672, vocab=128256, a gated
cross-attention image layer every 5th layer (20 of 100).  The vision front
end (ViT) is a stub: the data pipeline provides precomputed patch
embeddings (B, 6404, d_model) — 4 tiles x 1601 patches.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, cross_attn_every=5, frontend="vision", img_seq=6404,
    rope_theta=5e5, tie_embeddings=False,
    attention_impl="chunked", attn_chunk=2048, grad_accum=8,
)

SMOKE = ModelConfig(
    name="llama32-vision-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    cross_attn_every=2, frontend="vision", img_seq=32, tie_embeddings=False,
    attention_impl="dot", scan_chunk=16,
)
LR_SCHEDULE = "cosine"

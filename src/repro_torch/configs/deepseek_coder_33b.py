"""deepseek-coder-33b [dense, llama-arch] (arXiv:2401.14196; hf).

62L, d_model=7168, 56 heads (GQA kv=8), d_ff=19200, vocab=32256.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab=32256, rope_theta=1e5, tie_embeddings=False,
    attention_impl="chunked", attn_chunk=2048, grad_accum=4,
)

SMOKE = ModelConfig(
    name="deepseek-coder-smoke",
    n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
    tie_embeddings=False, attention_impl="dot", scan_chunk=16,
)
LR_SCHEDULE = "cosine"

"""recurrentgemma-2b [hybrid] (arXiv:2402.19427; hf) — RG-LRU + local
attention 1:2.

26L, d_model=2560, 10 heads (MQA kv=1, head_dim=256), d_ff=7680,
vocab=256000; pattern [rec, rec, attn] with 2048-token local attention;
lru_width == d_model (expand=1).  26 = 8x3 + 2: 8 whole pattern units and
2 remainder layers.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, block_pattern=("rec", "rec", "attn"), attn_window=2048,
    ssm_expand=1, tie_embeddings=True, grad_accum=4,
    attention_impl="chunked", attn_chunk=2048, scan_chunk=512,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=512,
    block_pattern=("rec", "rec", "attn"), attn_window=16, ssm_expand=1,
    tie_embeddings=True, attention_impl="dot", scan_chunk=16,
)
LR_SCHEDULE = "cosine"

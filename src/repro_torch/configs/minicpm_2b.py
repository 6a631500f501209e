"""minicpm-2b [dense] (arXiv:2404.06395; hf) — trains with the WSD schedule.

40L, d_model=2304, 36 heads (MHA kv=36), d_ff=5760, vocab=122753.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, tie_embeddings=True,
    attention_impl="chunked", attn_chunk=2048,
)

SMOKE = ModelConfig(
    name="minicpm-smoke",
    n_layers=4, d_model=96, n_heads=6, n_kv_heads=6, d_ff=192, vocab=512,
    tie_embeddings=True, attention_impl="dot", scan_chunk=16,
)
LR_SCHEDULE = "wsd"          # the paper's schedule, wired in optim/schedules

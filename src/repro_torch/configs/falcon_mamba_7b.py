"""falcon-mamba-7b [ssm] (arXiv:2410.05355) — attention-free Mamba-1.

64L, d_model=4096, d_inner=8192 (expand 2), ssm_state=16, conv 4,
vocab=65024, d_ff=0 (the mamba block carries its own 2x expansion).
Its state is O(1) in sequence length.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=65024, block_pattern=("mamba",), ssm_state=16, ssm_conv=4,
    ssm_expand=2, tie_embeddings=False, scan_chunk=256,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    n_layers=4, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=512,
    block_pattern=("mamba",), ssm_state=8, ssm_conv=4, ssm_expand=2,
    tie_embeddings=False, scan_chunk=16,
)
LR_SCHEDULE = "cosine"

"""seamless-m4t-medium [audio enc-dec] (arXiv:2308.11596; hf).

12L encoder + 12L decoder, d_model=1024, 16 heads (kv=16), d_ff=4096,
vocab=256206.  The audio front end (fbank -> conformer embedding) is a
stub: the data pipeline provides precomputed frame embeddings (B, T,
d_model), which the encoder reads.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, gated_mlp=False, encoder_decoder=True, enc_layers=12,
    frontend="audio", tie_embeddings=True, attention_impl="chunked",
    attn_chunk=2048, grad_accum=2,
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    encoder_decoder=True, enc_layers=2, frontend="audio",
    tie_embeddings=True, attention_impl="dot", scan_chunk=16,
)
LR_SCHEDULE = "cosine"

"""whisper-base [audio]: 6L enc + 6L dec, d=512, 8H MHA, d_ff=2048, vocab 51865.

[arXiv:2212.04356; unverified]  The JAX package's config: a 6-encoder +
6-decoder model (n_enc_layers=6, n_layers=6 decoder), MHA (kv=8 at 8
heads), the gelu FFN.  The conv audio frontend is a stub: the encoder
takes precomputed frame embeddings (1500 frames, the 30 s mel->conv output
length of whisper).  Positions use RoPE in the encoder and the decoder's
self-attention, as there (whisper's own are learned/sinusoidal).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    act="gelu",
    n_frontend_tokens=1500,
    frontend="audio",
))

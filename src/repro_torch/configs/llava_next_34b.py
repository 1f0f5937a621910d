"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  The anyres-tiling
vision frontend is a stub: 2880 precomputed patch embeddings (anyres 4+1
tiles x 576 patches) are prepended to the text tokens
(``lm_forward(embeds=)``); the 60-layer decoder is what is built.
~34.4 B parameters (137.5 GB in float32): on one card it runs at a cut
depth.  JAX's ``fsdp=True`` is carried for the sharding
rules; placing its "data"-sharded parameters (FSDP) is a later slice.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    n_frontend_tokens=2880,
    frontend="vision",
    fsdp=True,
))

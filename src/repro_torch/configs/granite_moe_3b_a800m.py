"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8), MoE 40e top-8, d_ff=512.

[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]  d_ff=512 is the
per-expert width; 3.30 B parameters (13.19 GB in float32).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512),
    tie_embeddings=True,
))

"""zamba2-1.2b [hybrid]: 38L d=2048, Mamba2 backbone + a shared attention block.

[arXiv:2411.15242]  38 Mamba2 layers with one weight-shared transformer
block (32H MHA, kv=32; d_ff=8192) applied after every 6th layer, each
application with its own KV cache.  ssm_state=64.  The shared attention
runs with a 4096-token sliding window.  ~1.2 B parameters (4.7 GB in
float32).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(d_state=64),
    attn_every=6,
    sliding_window=4096,
))

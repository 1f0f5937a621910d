"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf]  q, k and v carry biases, added after their
products.  ~32.8 B parameters (131 GB in float32): on one card it runs at
a cut depth.  JAX's ``fsdp=True`` is carried for the sharding
rules; placing its "data"-sharded parameters (FSDP) is a later slice.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    fsdp=True,
))

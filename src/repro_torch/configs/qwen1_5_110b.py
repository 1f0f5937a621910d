"""qwen1.5-110b [dense]: 80L d=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]  The largest dense arch of the registry,
trained with Adafactor (factored second moments, no momentum) as in the
JAX package.  ~111 B parameters (444 GB in float32): on one card it runs
at a cut depth.  JAX's ``fsdp=True`` is carried for
the sharding rules; placing its "data"-sharded parameters (FSDP) is a
later slice.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    optimizer="adafactor",
    fsdp=True,
))

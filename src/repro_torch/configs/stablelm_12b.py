"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b; hf]  Heads of 160 dims (5120 / 32).
~12.1 B parameters (48.6 GB in float32): served at full depth on one
80 GB card; adamw's moments do not fit there.  JAX's ``fsdp=True``
is carried for the sharding rules; placing its "data"-sharded
parameters (FSDP) is a later slice (ROADMAP §1).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    fsdp=True,
))

"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8), MoE 128e top-1.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  Llama-4-Maverick style:
routed top-1 over 128 experts plus one always-on shared expert,
MoE on every other layer (interleave=2), dense d_ff=8192 on the rest.
Early-fusion multimodality is a STUB (text-token path exercised;
``input_specs`` can prepend patch embeddings).  FSDP + Adafactor for the
400 B total parameters.

The port's stack is 24 (dense, MoE) pairs, JAX's scan block of two layers
(``scan_block=2``), run as a loop.  One pair with all 128 experts holds
18.55 G float32 parameters (74.2 GB with the embedding and the head), so
one card serves the arch at depth 2; training at full width holds the
experts cut to 16, Llama-4-Scout's count.  JAX's ``fsdp=True`` is carried for
the sharding rules; placing its "data"-sharded parameters (FSDP) is a
later slice.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, interleave=2,
                  n_shared_experts=1),
    optimizer="adafactor",
    fsdp=True,
))

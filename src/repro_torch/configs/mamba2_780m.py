"""mamba2-780m [ssm]: 48L d=1536, attention-free SSD, ssm_state=128, vocab 50280.

[arXiv:2405.21060]  d_ff=0: no separate MLP, the Mamba2 block carries
expand=2 internal width.  ~0.78 B parameters (3.1 GB in float32).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128),
    tie_embeddings=True,
))

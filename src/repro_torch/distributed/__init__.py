"""Multi-rank execution: sharding rules, int8 gradient compression and the
sharded kernel dispatch (the JAX package's ``repro.distributed`` exports).
The model layers call ``shard_fused`` per op: ``parallel_matmul``,
``parallel_attention``, ``parallel_conv2d``."""
from repro_torch.distributed.sharding import (  # noqa: F401
    batch_spec, cache_specs, data_axes, gather_tree, lm_param_specs, opt_state_specs,
    shard_tree,
)
from repro_torch.distributed.compression import (  # noqa: F401
    compressed_all_reduce, dequantize_int8, init_ef_state, quantize_int8,
)
from repro_torch.distributed import shard_fused  # noqa: F401

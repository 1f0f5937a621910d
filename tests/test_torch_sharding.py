"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``), in one process: the
parameter specs of every registered arch at full size (JAX's tree from
``jax.eval_shape``), the optimizer-state specs, and the decode-cache specs
(rings with batches that the data axes divide and do not, the paged
pools), on 2x2, 4x2 and (2, 2, 2) meshes.  JAX gets a stand-in mesh
carrying ``axis_names``, ``shape`` and ``devices.shape``; the port its
``MeshShape``.  Also: the blocks ``shard_tensor`` cuts for every rank tile
the full tensor, and placing an FSDP spec raises.
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.launch.mesh import MeshShape

MESHES = {"2x2": (2, 2), "4x2": (4, 2), "2x2x2": (2, 2, 2)}


def _archs():
    get_arch("granite-3-2b")
    from repro_torch.configs.base import ARCH_REGISTRY
    return sorted(ARCH_REGISTRY)


def _jax_mesh(sizes):
    names = ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)),
                                 devices=types.SimpleNamespace(shape=tuple(sizes)))


def _flat_specs(tree):
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.distributed.sharding import _path_str
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_path_str(path).replace("/", "."): tuple(spec) for path, spec in flat}


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    import jax
    from repro.configs import get_arch as jax_arch
    cfg = jax_arch(name)
    if cfg.family == "encdec":
        from repro.models.encdec import init_encdec
        return jax.eval_shape(lambda k: init_encdec(k, cfg), jax.random.PRNGKey(0))
    from repro.models.transformer import init_lm
    return jax.eval_shape(lambda k: init_lm(k, cfg), jax.random.PRNGKey(0))


def _port_shapes(cfg):
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_param_shapes
        return encdec_param_shapes(cfg)
    from repro_torch.models.transformer import lm_param_shapes
    return lm_param_shapes(cfg)


@pytest.mark.parametrize("arch", _archs())
def test_param_and_opt_state_specs_equal_jax(arch):
    from repro.configs import get_arch as jax_arch
    from repro.distributed.sharding import lm_param_pspecs, opt_state_pspecs

    from repro_torch.distributed.sharding import lm_param_specs, opt_state_specs
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    assert cfg.fsdp == jcfg.fsdp
    params = _jax_params(arch)
    for mesh_name, sizes in MESHES.items():
        jspecs = lm_param_pspecs(params, jcfg, _jax_mesh(sizes))
        want = _flat_specs(jspecs)
        got = lm_param_specs(_port_shapes(cfg), cfg, MeshShape(sizes), stacked=True)
        assert got == want, (mesh_name, {k: (got.get(k), want.get(k)) for k in set(got) | set(
            want) if got.get(k) != want.get(k)})
        for opt in ("adamw", "adafactor", "sgdm"):
            jopt = _flat_specs(opt_state_pspecs(opt, jspecs))
            port = opt_state_specs(opt, got)
            flat = {f"{top}.{name}": spec for top in port if top != "step"
                    for name, spec in _dotted(port[top]).items()}
            flat["step"] = port["step"]
            assert flat == jopt, (mesh_name, opt)


def _dotted(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_dotted(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _layer_specs(port, jax_stacked):
    """The port's cache specs, in its structure of layer lists, against JAX's
    stacked specs: a layer's spec is the stacked one without the layer
    entry."""
    if isinstance(port, list):
        for member in port:
            _layer_specs(member, jax_stacked)
        return
    if isinstance(port, tuple) and port and isinstance(port[0], (list, dict)):
        for p, j in zip(port, jax_stacked):
            _layer_specs(p, j)
        return
    if isinstance(port, dict):
        for k, v in port.items():
            _layer_specs(v, jax_stacked[k])
        return
    want = tuple(jax_stacked)
    assert port == (want[1:] if want else ()), (port, want)


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-3b-a800m", "mamba2-780m",
                                  "zamba2-1.2b", "llama4-maverick-400b-a17b"])
def test_cache_specs_equal_jax(arch):
    import jax
    from repro.configs import get_arch as jax_arch
    from repro.distributed.sharding import cache_pspecs
    from repro.models.transformer import init_lm_caches as jax_caches

    from repro_torch.distributed.sharding import cache_specs
    from repro_torch.models.transformer import init_lm_caches
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    for sizes in MESHES.values():
        for batch in (8, 1):
            jc = jax.eval_shape(lambda: jax_caches(jcfg, batch, 64))
            want = cache_pspecs(jc, _jax_mesh(sizes), batch)
            got = cache_specs(init_lm_caches(cfg, batch, 64, "meta"), MeshShape(sizes), batch)
            _layer_specs(got, want)
    if cfg.family == "dense":
        from repro.models.transformer import init_paged_lm_caches as jax_paged

        from repro_torch.models.transformer import init_paged_lm_caches
        jc = jax.eval_shape(lambda: jax_paged(jcfg, 33, 16))
        want = cache_pspecs(jc, _jax_mesh((2, 2)), 4)
        _layer_specs(cache_specs(init_paged_lm_caches(cfg, 33, 16, "meta"), MeshShape((2, 2)), 4),
                     want)


class _Rank(MeshShape):
    """A rank's coordinates on a mesh shape, with ``Mesh.block``/``index``."""

    def __init__(self, sizes, rank):
        super().__init__(sizes)
        self.coords = self.coords_of(rank)

    from repro_torch.launch.mesh import Mesh as _M
    index, block = _M.index, _M.block


@pytest.mark.parametrize("spec", [(None, "model"), ("model", None), ("data", "model"),
                                  (("pod", "data"), "model"), (None, None)])
def test_rank_blocks_tile_the_tensor(spec):
    from repro_torch.distributed.sharding import shard_tensor
    sizes = (2, 2, 2)
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    seen = torch.zeros_like(t)
    for r in range(8):
        block = shard_tensor(t, spec, _Rank(sizes, r))
        replicas = 8 // np.prod([_Rank(sizes, 0).axes_size(a) for a in spec if a is not None])
        seen[np.isin(t.numpy(), block.numpy())] += 1.0 / replicas
    assert torch.equal(seen, torch.ones_like(t))


def test_placing_fsdp_raises():
    from repro_torch.distributed.sharding import check_placeable, lm_param_specs
    from repro_torch.models.transformer import lm_param_shapes
    cfg = get_arch("stablelm-12b")
    specs = lm_param_specs(lm_param_shapes(cfg), cfg, MeshShape((2, 2)))
    assert specs["layers.0.attn.wq.w"] == ("data", "model")
    with pytest.raises(NotImplementedError, match="FSDP"):
        check_placeable("layers.0.attn.wq.w", specs["layers.0.attn.wq.w"])
    granite = get_arch("granite-3-2b")
    specs = lm_param_specs(lm_param_shapes(granite), granite, MeshShape((2, 2)))
    assert specs["embed.emb"] == (None, "model")        # vocab 49155 is odd: d takes "model"
    assert specs["layers.0.attn.wq.w"] == (None, "model")
    assert specs["layers.0.ffn.wd.w"] == ("model", None)

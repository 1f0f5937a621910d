"""The port's vision models against the JAX package, and its hygiene.

Small LeNet-300-100-, LeNet-5- and resnet-shaped configs: the JAX
``init_vision`` parameters are carried across with
``vision_params_from_jax``, and the port's logits (``amsim_torch`` on the
CPU) are held against JAX ``vision_forward`` (``amsim``, interpret mode),
and ``native`` against ``native``.  The package itself must never import
JAX or the JAX package, and must not fall back to the CPU on its own.
"""
import ast
import functools
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import VisionConfig as JaxVisionConfig  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.models import vision as jvision  # noqa: E402
from repro_torch.configs.paper_models import VISION_REGISTRY, VisionConfig  # noqa: E402
from repro_torch.convert import vision_params_from_jax  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.data.pipeline import vision_dataset  # noqa: E402
from repro_torch.models import vision  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        yield


SMALL = {
    "mlp": dict(name="mlp-small", kind="mlp", input_hw=6, input_ch=1, n_classes=5,
                hidden=(12, 8)),
    "cnn": dict(name="cnn-small", kind="cnn", input_hw=8, input_ch=1, n_classes=5,
                channels=(3, 4), hidden=(12, 8)),
    "resnet": dict(name="resnet-small", kind="resnet", input_hw=8, input_ch=3, n_classes=5,
                   channels=(4, 8), blocks_per_stage=2),
}


def _jax_forward(params, x, jcfg, policy):
    fwd = jax.jit(functools.partial(jvision.vision_forward, cfg=jcfg, policy=policy))
    return np.asarray(fwd(params, jnp.asarray(x)))


def _carried(kind, seed=1):
    spec = SMALL[kind]
    jcfg = JaxVisionConfig(**spec)
    params = jax.tree_util.tree_map(np.asarray, jvision.init_vision(jax.random.PRNGKey(seed),
                                                                     jcfg))
    return jcfg, params, vision_params_from_jax(params, VisionConfig(**spec), device="cpu")


@pytest.mark.parametrize("kind", ["mlp", "cnn", "resnet"])
def test_amsim_logits_match_jax(kind, rng):
    """JAX runs its kernels at their default tiling, which sums chunks of
    products before adding them, and pools and means in its own order; the
    port folds one product at a time.  Each of the <= 6 layers adds
    float32 reassociation error of a few ulps of its partial sums, so the
    logits agree to rtol=atol=1e-5 (logits are O(1)), and the argmax
    agrees."""
    jcfg, params, model = _carried(kind)
    x = rng.uniform(0, 1, (2, jcfg.input_hw, jcfg.input_hw, jcfg.input_ch)).astype(np.float32)
    ref = _jax_forward(params, x, jcfg, JaxPolicy(mode="amsim", multiplier="afm16"))
    out = vision.vision_forward(model, torch.from_numpy(x),
                                NumericsPolicy(mode="amsim_torch", multiplier="afm16")).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("kind", ["mlp", "cnn", "resnet"])
def test_native_logits_match_jax(kind, rng):
    jcfg, params, model = _carried(kind)
    x = rng.uniform(0, 1, (2, jcfg.input_hw, jcfg.input_hw, jcfg.input_ch)).astype(np.float32)
    ref = _jax_forward(params, x, jcfg, JaxPolicy())
    out = vision.vision_forward(model, torch.from_numpy(x), NumericsPolicy()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_converter_keeps_names_and_shapes_and_rejects_misfits():
    _, params, model = _carried("resnet")
    w = model.stages[1][0].proj.w
    assert tuple(w.shape) == (1, 1, 4, 8)
    np.testing.assert_array_equal(w.detach().numpy(), params["stages"][1][0]["proj"]["w"])
    with pytest.raises(ValueError, match="does not fit"):
        vision_params_from_jax(params, VisionConfig(**SMALL["cnn"]), device="cpu")


def test_registry_matches_jax():
    from repro.configs.paper_models import VISION_REGISTRY as JAX_REGISTRY
    assert {k: vars(v) for k, v in VISION_REGISTRY.items()} == \
        {k: vars(v) for k, v in JAX_REGISTRY.items()}


def test_init_vision_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vision.init_vision(VISION_REGISTRY["lenet-5"])
    model = vision.init_vision(VISION_REGISTRY["lenet-5"], device="cpu")
    assert model.dense[0].w.device.type == "cpu"
    assert tuple(model.dense[0].w.shape) == (7 * 7 * 16, 120)


def test_vision_dataset_is_the_same_in_every_process():
    code = ("import zlib; from repro_torch.data.pipeline import vision_dataset as v; "
            "d = v('cifar', 4, 2, 8, 3, 10); print(zlib.crc32(d['x_train'].tobytes()))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "PYTHONHASHSEED": "random"}
    runs = {subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                           text=True, check=True).stdout.strip() for _ in range(2)}
    here = str(zlib.crc32(vision_dataset("cifar", 4, 2, 8, 3, 10)["x_train"].tobytes()))
    assert runs == {here}


# ------------------------------------------------------------------ hygiene
def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, repro_torch.models.vision, repro_torch.convert, "
            "repro_torch.data.pipeline; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}).stdout
    assert out.strip() == "[]"

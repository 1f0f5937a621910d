"""The port's training slice against the JAX package.

On the CPU the kernel wrappers run their plain versions, so:
* the plain conv weight gradient is bitwise equal to JAX
  ``approx_conv2d_dw`` at chunk=1 (Pallas interpret mode);
* the conv dx and GEMM da/db of the port's autograd backward are bitwise
  equal to the JAX kernels at chunk=1 on the same dilated, flipped and
  transposed operands;
* ``approx_backward=False`` gives the native backward, and a gradient
  whose input needs none is not computed;
* one ``make_train_step`` step matches JAX ``make_train_step`` on shared
  parameters and a shared batch (native, and ``amsim_torch`` against
  ``amsim_jnp``), and sgdm matches JAX ``sgdm`` bitwise;
* the ``direct`` mode's ``torch_mul`` is bitwise equal to ``np_mul``.
The dw CUDA kernel itself is held against its plain version on the card
in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import VISION_REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs.paper_models import VisionConfig as JaxVisionConfig  # noqa: E402
from repro.core import multipliers as jmult  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.kernels import approx_conv as japprox_conv  # noqa: E402
from repro.kernels import approx_gemm as japprox_gemm  # noqa: E402
from repro.kernels.ref import ref_direct_gemm as jref_direct_gemm  # noqa: E402
from repro.models import vision as jvision  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.paper_models import VisionConfig  # noqa: E402
from repro_torch.convert import vision_params_from_jax, vision_params_to_numpy  # noqa: E402
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.float_bits import np_bits  # noqa: E402
from repro_torch.core.multipliers import get_multiplier  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.data.pipeline import vision_dataset  # noqa: E402
from repro_torch.kernels import approx_conv, ops  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402
from repro_torch.kernels.ref import ref_direct_gemm  # noqa: E402
from repro_torch.models import vision  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.train import convergence  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

AMSIM = NumericsPolicy(mode="amsim", multiplier="afm16")


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        yield


def _lut(name, packed):
    table = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    return table, get_multiplier(name).mantissa_bits


def _t(a, requires_grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(requires_grad)


# ------------------------------------------------------ dw: plain vs JAX
DW_CASES = [
    # (x shape, w shape, stride, padding)
    ((2, 6, 6, 3), (3, 3, 3, 4), 1, "SAME"),
    ((2, 8, 8, 3), (3, 3, 3, 4), 2, "SAME"),   # even input: pads (0, 1)
    ((2, 8, 8, 3), (1, 1, 3, 4), 2, "SAME"),
    ((1, 9, 9, 2), (5, 5, 2, 3), 1, "VALID"),
    ((2, 7, 5, 2), (3, 3, 2, 3), 2, "SAME"),   # odd H x W
]


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("xs,ws,stride,padding", DW_CASES)
def test_plain_dw_bitwise_vs_jax_chunk1(xs, ws, stride, padding, packed, rng):
    table, M = _lut("afm16", packed)
    kh, kw, _, o = ws
    pads = approx_conv.conv_pads(xs[1], xs[2], kh, kw, stride, padding)
    oh, ow = approx_conv.conv_out_shape(xs[1], xs[2], kh, kw, stride, pads)
    x = rng.standard_normal(xs).astype(np.float32)
    g = rng.standard_normal((xs[0], oh, ow, o)).astype(np.float32)
    ref = japprox_conv.approx_conv2d_dw(jnp.asarray(x), jnp.asarray(g), jnp.asarray(table), M,
                                        kh=kh, kw=kw, stride=stride, padding=padding, chunk=1,
                                        interpret=True)
    out = approx_conv.approx_conv2d_dw(_t(x), _t(g), lut_tensor(table, "cpu"), M, kh=kh, kw=kw,
                                       stride=stride, padding=padding)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_dw_wrapper_rejects_a_mismatched_error(rng):
    table, M = _lut("afm16", True)
    with pytest.raises(ValueError, match="gives"):
        approx_conv.approx_conv2d_dw(torch.zeros((1, 8, 8, 2)), torch.zeros((1, 8, 8, 3)),
                                     lut_tensor(table, "cpu"), M, kh=3, kw=3, stride=2)


# ------------------------------------------- backward vs the JAX kernels
def _jax_dx_operands(g, w, h, wid, stride, pads):
    """The dilated error, reversed IO-transposed weights and pads of the
    JAX package's conv backward (``repro/kernels/ops.py:_conv_bwd``)."""
    n, oh, ow, o = g.shape
    kh, kw = w.shape[:2]
    gd = np.zeros((n, (oh - 1) * stride + 1, (ow - 1) * stride + 1, o), np.float32)
    gd[:, ::stride, ::stride, :] = g
    pt, pl = kh - 1 - pads[0], kw - 1 - pads[2]
    pb = h - (gd.shape[1] + pt - kh + 1)
    pr = wid - (gd.shape[2] + pl - kw + 1)
    return gd, np.transpose(w[::-1, ::-1], (0, 1, 3, 2)), (pt, pb, pl, pr)


@pytest.mark.parametrize("xs,ws,stride,padding", DW_CASES)
def test_conv_backward_bitwise_vs_jax_kernels_chunk1(xs, ws, stride, padding, rng):
    table, M = _lut("afm16", True)    # ops picks the packed table for afm16
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    xt, wt = _t(x, True), _t(w, True)
    y = ops.approx_conv2d(xt, wt, stride, padding, AMSIM)
    g = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(g))
    pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, padding)
    gd, wrt, dpads = _jax_dx_operands(g, w, xs[1], xs[2], stride, pads)
    ref_dx = japprox_conv.approx_conv2d_fused(
        jnp.asarray(gd), jnp.asarray(wrt), jnp.asarray(table), M, stride=1, padding=dpads,
        br=1, bo=4, chunk=1, interpret=True)
    ref_dw = japprox_conv.approx_conv2d_dw(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(table), M, kh=ws[0], kw=ws[1],
        stride=stride, padding=padding, chunk=1, interpret=True)
    np.testing.assert_array_equal(dx.numpy(), np.asarray(ref_dx))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(ref_dw))


def test_gemm_backward_bitwise_vs_jax_kernel_chunk1(rng):
    """da = g @ b^T and db = a_flat^T @ g_flat, the batch rows folded into
    one GEMM, as the JAX ``_mm_bwd`` does."""
    table, M = _lut("afm16", True)
    a = rng.standard_normal((2, 3, 20)).astype(np.float32)
    b = rng.standard_normal((20, 7)).astype(np.float32)
    g = rng.standard_normal((2, 3, 7)).astype(np.float32)
    at, bt = _t(a, True), _t(b, True)
    da, db = torch.autograd.grad(ops.policy_matmul(at, bt, AMSIM, "dense"), (at, bt), _t(g))
    gemm = functools.partial(japprox_gemm.approx_gemm, lut=jnp.asarray(table), M=M, bm=128,
                             bn=128, bk=128, chunk=1, interpret=True)
    ref_da = gemm(jnp.asarray(g.reshape(6, 7)), jnp.asarray(b.T))
    ref_db = gemm(jnp.asarray(a.reshape(6, 20).T), jnp.asarray(g.reshape(6, 7)))
    np.testing.assert_array_equal(da.numpy(), np.asarray(ref_da).reshape(a.shape))
    np.testing.assert_array_equal(db.numpy(), np.asarray(ref_db))


def _grads(fn, inputs, g):
    out = fn(*inputs)
    return torch.autograd.grad(out, [t for t in inputs if t.requires_grad], _t(g))


@pytest.mark.parametrize("stride", [1, 2])
def test_exact_backward_is_the_native_backward(stride, rng):
    """With approx_backward=False only the forward is approximate: dx and
    dw equal the native backward's bit for bit (they depend on x, w and g
    alone)."""
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    g = rng.standard_normal((2, 8 // stride, 8 // stride, 4)).astype(np.float32)
    exact_bwd = NumericsPolicy(mode="amsim_torch", multiplier="afm16", approx_backward=False)
    got = _grads(lambda a, b: ops.approx_conv2d(a, b, stride, "SAME", exact_bwd),
                 (_t(x, True), _t(w, True)), g)
    want = _grads(lambda a, b: ops.approx_conv2d(a, b, stride, "SAME", NumericsPolicy()),
                  (_t(x, True), _t(w, True)), g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    a2 = rng.standard_normal((5, 6)).astype(np.float32)
    b2 = rng.standard_normal((6, 3)).astype(np.float32)
    g2 = rng.standard_normal((5, 3)).astype(np.float32)
    got = _grads(lambda a, b: ops.policy_matmul(a, b, exact_bwd), (_t(a2, True), _t(b2, True)),
                 g2)
    want = _grads(lambda a, b: ops.policy_matmul(a, b, NumericsPolicy()),
                  (_t(a2, True), _t(b2, True)), g2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_native_backward_matches_jax(rng):
    """native against native, stride 2 on an even input (asymmetric pads):
    exact float32 both sides, sums in other orders."""
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    g = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    from repro.kernels import ops as jops
    _, vjp = jax.vjp(lambda a, b: jops.approx_conv2d(a, b, 2, "SAME", JaxPolicy()),
                     jnp.asarray(x), jnp.asarray(w))
    ref = vjp(jnp.asarray(g))
    got = _grads(lambda a, b: ops.approx_conv2d(a, b, 2, "SAME", NumericsPolicy()),
                 (_t(x, True), _t(w, True)), g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_a_gradient_no_input_needs_is_not_computed(monkeypatch, rng):
    calls = {"fwd_kernel": 0, "dw_kernel": 0}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(ops, "approx_conv2d_fused", count("fwd_kernel", ops.approx_conv2d_fused))
    monkeypatch.setattr(ops, "approx_conv2d_dw", count("dw_kernel", ops.approx_conv2d_dw))
    x = _t(rng.standard_normal((1, 6, 6, 2)).astype(np.float32))     # an image: no grad
    w = _t(rng.standard_normal((3, 3, 2, 3)).astype(np.float32), True)
    ops.approx_conv2d(x, w, 1, "SAME", AMSIM).sum().backward()
    assert calls == {"fwd_kernel": 1, "dw_kernel": 1}               # fwd and dw, no dx
    ops.approx_conv2d(x.requires_grad_(), w.detach(), 1, "SAME", AMSIM).sum().backward()
    assert calls == {"fwd_kernel": 3, "dw_kernel": 1}               # fwd and dx, no dw


# ------------------------------------------------ one step against JAX
STEP_MODELS = {
    "lenet-300-100": JAX_REGISTRY["lenet-300-100"],
    "lenet-5": JAX_REGISTRY["lenet-5"],
    "resnet-narrow": JaxVisionConfig(name="resnet-narrow", kind="resnet", input_hw=8,
                                     input_ch=3, n_classes=10, channels=(4, 8),
                                     blocks_per_stage=1),
}


@pytest.mark.parametrize("modes", [("native", "native"), ("amsim_torch", "amsim_jnp")])
@pytest.mark.parametrize("model_name", list(STEP_MODELS))
def test_train_step_matches_jax(model_name, modes, rng):
    """One sgdm step (lr 0.05, clip 1.0) from shared parameters on a shared
    batch of 4.  Tolerance: loss rel <= 1e-5, and each parameter leaf after
    the step within ||d|| / ||p|| <= 1e-4.  Elementwise rtol would be
    brittle: the non-LUT autodiff (softmax, bias sums, the global norm)
    rounds in other orders in the two frameworks, and a 1-ulp difference
    there can flip a 7-bit LUT index of a later product."""
    jcfg = STEP_MODELS[model_name]
    cfg = VisionConfig(**vars(jcfg))
    mult = "afm16"
    jpol = JaxPolicy(mode=modes[1], multiplier=mult) if modes[1] != "native" else JaxPolicy()
    pol = NumericsPolicy(mode=modes[0], multiplier=mult) if modes[0] != "native" \
        else NumericsPolicy()
    params = jax.tree_util.tree_map(np.asarray, jvision.init_vision(jax.random.PRNGKey(3), jcfg))
    x = rng.uniform(0, 1, (4, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, 4).astype(np.int32)

    jopt = joptim.sgdm(0.05)
    jstep = jax.jit(jmake_train_step(lambda p, b: jvision.vision_loss(p, b, jcfg, jpol), jopt))
    jparams, _, jm = jstep(params, jopt.init(params), {"x": jnp.asarray(x), "y": jnp.asarray(y)})

    model = vision_params_from_jax(params, cfg, device="cpu")
    opt = optimizers.sgdm(0.05)
    step = make_train_step(lambda m, b: vision.vision_loss(m, b, pol), opt)
    _, m = step(model, opt.init(dict(model.named_parameters())), {"x": _t(x), "y": _t(y)})

    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    got = jax.tree_util.tree_leaves(vision_params_to_numpy(model))
    want = jax.tree_util.tree_leaves(jparams)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)


def test_sgdm_bitwise_vs_jax(rng):
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(lambda v: rng.standard_normal(v.shape).astype(np.float32),
                                    tree) for _ in range(3)]
    jopt = joptim.sgdm(0.05, weight_decay=1e-3)
    jparams, jstate = tree, jopt.init(tree)
    params = optimizers.tree_map(lambda v: _t(v.copy()), tree)
    opt = optimizers.sgdm(0.05, weight_decay=1e-3)
    state = opt.init(params)
    for g in grads:
        upd, jstate = jopt.update(g, jstate, jparams)
        jparams = joptim.apply_updates(jparams, upd)
        upd, state = opt.update(optimizers.tree_map(_t, g), state, params)
        optimizers.apply_updates(params, upd)
    for a, b in zip(optimizers.tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np_bits(a.numpy()), np_bits(np.asarray(b)))
    assert state["step"] == int(jstate["step"]) == 3


def test_schedules_and_clipping_match_jax(rng):
    for step in (0, 3, 10, 50, 120):
        np.testing.assert_allclose(float(optimizers.cosine_schedule(0.1, 10, 100)(step)),
                                   float(joptim.cosine_schedule(0.1, 10, 100)(step)), rtol=1e-6)
    assert float(optimizers.constant_schedule(0.05)(7)) == float(joptim.constant_schedule(0.05)(7))
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}
    clipped, norm = optimizers.clip_by_global_norm(optimizers.tree_map(_t, tree), 1.0)
    jclipped, jnorm = joptim.clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]), rtol=1e-6)
    # make_optimizer("adamw") is the JAX adamw: one step on the same tree,
    # parameters bitwise equal (tests/test_torch_lm_train.py holds three
    # steps on an LM, and adafactor).
    params = optimizers.tree_map(lambda a: _t(a.copy()), tree)
    opt = optimizers.make_optimizer("adamw", optimizers.cosine_schedule(0.1, 10, 100))
    jopt = joptim.make_optimizer("adamw", joptim.cosine_schedule(0.1, 10, 100))
    upd, state = opt.update(optimizers.tree_map(_t, tree), opt.init(params), params)
    optimizers.apply_updates(params, upd)
    jupd, _ = jopt.update(tree, jopt.init(tree), tree)
    for k, p in joptim.apply_updates(tree, jupd).items():
        np.testing.assert_array_equal(np_bits(params[k].numpy()), np_bits(np.asarray(p)))


def test_microbatches_match_one_batch(rng):
    cfg = VisionConfig(name="mlp-small", kind="mlp", input_hw=6, input_ch=1, n_classes=5,
                       hidden=(12, 8))
    x = _t(rng.uniform(0, 1, (4, 6, 6, 1)).astype(np.float32))
    y = _t(rng.integers(0, 5, 4).astype(np.int64))
    out = []
    for mb in (1, 2):
        model = vision.init_vision(cfg, device="cpu")
        opt = optimizers.sgdm(0.05)
        step = make_train_step(lambda m, b: vision.vision_loss(m, b, NumericsPolicy()), opt,
                               microbatches=mb)
        _, metrics = step(model, opt.init(dict(model.named_parameters())), {"x": x, "y": y})
        out.append((metrics, [p.detach().clone() for p in model.parameters()]))
    (m1, p1), (m2, p2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6, atol=1e-6)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)


def test_params_to_numpy_inverts_from_jax():
    jcfg = STEP_MODELS["resnet-narrow"]
    params = jax.tree_util.tree_map(np.asarray, jvision.init_vision(jax.random.PRNGKey(1), jcfg))
    back = vision_params_to_numpy(vision_params_from_jax(params, VisionConfig(**vars(jcfg)),
                                                         device="cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- direct
def _grids(rng):
    """Random operands plus the boundary subgrids of tests/test_multipliers.py:
    exponent sums around underflow and overflow, denormal inputs and
    products, signed zeros, the min-normal boundary."""
    vals = [0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 1.17549435e-38, -1.17549435e-38,
            3.4028235e38, -3.4028235e38, 1.9999999, 1.0, -1.5, 2.0 ** -100, 2.0 ** -30,
            1.5 * 2.0 ** -63, 2.0 ** -64]
    for e in (-64, -63, -62, -60, 63, 64, 65, 126, 127):
        for mnt in (1.0, 1.25, 1.75, 1.9921875, 1.99999):
            vals += [np.float32(mnt * 2.0 ** e), np.float32(-mnt * 2.0 ** e)]
    v = np.asarray(vals, np.float32)
    ga, gb = np.meshgrid(v, v, indexing="ij")
    near = (np.float32(2.0 ** -60) * (1 + rng.random(256))).astype(np.float32)
    a = np.concatenate([ga.ravel(), (rng.standard_normal(8192) * 10).astype(np.float32), near])
    b = np.concatenate([gb.ravel(), (rng.standard_normal(8192) * 10).astype(np.float32),
                        near[::-1].copy()])
    return a, b


@pytest.mark.parametrize("name", ["afm32", "bf16", "trunc16", "mitchell8", "fp32", "realm16"])
def test_torch_mul_bitwise_vs_np_mul(name, rng):
    a, b = _grids(rng)
    ours = get_multiplier(name).torch_mul(_t(a), _t(b)).numpy()
    ref = jmult.get_multiplier(name).np_mul(a, b)
    np.testing.assert_array_equal(np_bits(ours), np_bits(ref))


def test_direct_gemm_close_to_jax(rng):
    """JAX sums each chunk of products before adding it; the port folds one
    product at a time: allclose at float32 resolution."""
    a = rng.standard_normal((9, 300)).astype(np.float32)
    b = rng.standard_normal((300, 5)).astype(np.float32)
    out = ref_direct_gemm(_t(a), _t(b), get_multiplier("afm32")).numpy()
    ref = np.asarray(jref_direct_gemm(jnp.asarray(a), jnp.asarray(b),
                                      jmult.get_multiplier("afm32")))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def test_direct_conv_and_its_gradients_close_to_jax(rng):
    """afm32 ``direct`` through the conv's forward, dx and dw against the
    JAX package's ``direct`` mode (the jnp twin, chunked sums): allclose."""
    from repro.kernels import ops as jops
    x = rng.standard_normal((1, 6, 6, 2)).astype(np.float32)
    w = rng.standard_normal((3, 3, 2, 3)).astype(np.float32)
    g = rng.standard_normal((1, 3, 3, 3)).astype(np.float32)
    jpol = JaxPolicy(mode="direct", multiplier="afm32")
    ref, vjp = jax.vjp(lambda a, b: jops.approx_conv2d(a, b, 2, "SAME", jpol),
                       jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    y = ops.approx_conv2d(xt, wt, 2, "SAME", NumericsPolicy(mode="direct", multiplier="afm32"))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for a, b in zip(torch.autograd.grad(y, (xt, wt), _t(g)), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------- convergence
def test_convergence_trains_under_all_four_multipliers():
    cfg = VisionConfig(name="mlp-small", kind="mlp", input_hw=8, input_ch=1, n_classes=4,
                       hidden=(16,))
    data = vision_dataset(cfg.name, 128, 32, 8, 1, 4)
    for name, pol in convergence.build_policies("amsim_torch").items():
        curve, acc, model, losses = convergence.train_one(cfg, pol, data, epochs=2, batch=16,
                                                          device="cpu")
        assert len(curve) == 2 and len(losses) == 16 and 0.0 <= acc <= 1.0, name
        assert np.mean(losses[-4:]) < np.mean(losses[:4]), (name, losses)

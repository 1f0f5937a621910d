"""The port's sweep runners (``launch/sweep.py``, ``launch/faultsweep.py``),
mirroring ``tests/test_sweep.py`` and the campaign of ``tests/test_faults.py``.

On the CPU, at reduced sizes:
* the assignment sweep's report (the JAX ``REPORT_SCHEMA``), its grid forms
  (``--point``, a 2-site x 2-multiplier cross product, ``--grid-json``),
  one train step built a point, and the tables it uploads;
* the loss and every gradient of reduced granite-3-2b under a mixed table
  and under ``fp16xbf16`` against JAX ``lm_loss`` on the same parameters
  and batch (the sweep's objective, end to end);
* a lenet-300-100 fault campaign: the report, rate 0 bitwise the clean
  run, a faulted point bitwise alike under ``amsim`` (packed table) and
  ``amsim_torch`` (canonical), one upload a faulted table, the degradation
  ladder building one step a rung, and the LM problem.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.launch import sweep as jsweep  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.configs.paper_models import VISION_REGISTRY  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_tree_to_numpy  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.faults import FaultSpec  # noqa: E402
from repro_torch.core.policy import NumericsPolicy, table_from_assignments  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import faultsweep, sweep  # noqa: E402
from repro_torch.models.transformer import lm_loss  # noqa: E402

SMALL = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16", "--n-layers", "1"]


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table: give this module its own directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        yield


@pytest.fixture(autouse=True)
def _own_table_cache(monkeypatch):
    """Each test counts its own uploads: a fresh process-wide table cache."""
    monkeypatch.setattr(ops, "_LUTS", {})
    monkeypatch.setattr(ops, "lut_uploads", {})
    faults.clear_active()
    yield
    faults.clear_active()


# ------------------------------------------------------------- the sweep
def test_sweep_smoke_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    report = sweep.main(SMALL + ["--steps", "2", "--point",
                                 "qkv=amsim_torch:mitchell8,default=native", "--out", str(out)])
    on_disk = json.loads(out.read_text())
    assert on_disk["schema"] == report["schema"] == sweep.REPORT_SCHEMA == jsweep.REPORT_SCHEMA
    assert report["arch"].endswith("-smoke") and report["n_layers"] == 1
    assert len(report["points"]) == 1
    pt = report["points"][0]
    assert len(pt["losses"]) == 2 and pt["traces"] == 1 and len(pt["step_ms"]) == 2
    assert "final_vs_baseline" in pt and "rules" in pt and pt["peak_bytes"] is None
    assert pt["uploads"] == 1                            # mitchell8, canonical
    base = report["baseline"]
    assert len(base["losses"]) == 2 and base["traces"] == 1 and base["uploads"] == 0
    assert pt["losses"][0] != base["losses"][0]
    assert on_disk["points"][0]["losses"] == pt["losses"]
    assert "[sweep] point: qkv=amsim_torch:mitchell8" in capsys.readouterr().out


def test_sweep_cross_product_expansion():
    """The 2-site x 2-multiplier grid: four points, the two mitchell8
    points share one upload, bf16 another."""
    report = sweep.main(SMALL + ["--steps", "1", "--no-baseline", "--cross-sites", "qkv,wd",
                                 "--cross-multipliers", "amsim_torch:mitchell8,amsim:bf16"])
    assigns = [p["assign"] for p in report["points"]]
    assert assigns == ["qkv=amsim_torch:mitchell8,default=native",
                       "qkv=amsim:bf16,default=native",
                       "wd=amsim_torch:mitchell8,default=native",
                       "wd=amsim:bf16,default=native"]
    assert "baseline" not in report
    assert [p["traces"] for p in report["points"]] == [1, 1, 1, 1]
    assert [p["uploads"] for p in report["points"]] == [1, 1, 0, 0]


def test_sweep_grid_json_and_bad_args(tmp_path):
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps({"points": ["head=amsim_torch:bf16,default=native"]}))
    report = sweep.main(SMALL + ["--steps", "1", "--no-baseline", "--grid-json", str(grid)])
    assert report["points"][0]["assign"].startswith("head=")
    with pytest.raises(SystemExit):
        sweep.main(["--device", "cpu", "--steps", "1"])
    with pytest.raises(SystemExit):
        sweep.main(["--device", "cpu", "--steps", "1", "--cross-sites", "qkv"])


def test_sweep_point_uses_the_step_wrapper():
    wrapped = []

    def wrapper(step):
        wrapped.append(step)
        return step

    cfg = reduced(get_arch("granite-3-2b"), n_layers=1)
    res = sweep.run_point(cfg, table_from_assignments("default=amsim_torch:fp16xbf16"), steps=1,
                          batch=2, seq=8, device="cpu", step_wrapper=wrapper)
    assert len(wrapped) == 1 and res["traces"] == 1 and res["uploads"] == 1


SWEEP_TABLES = {
    "mixed": "qkv=mitchell8,attn_score=bf16,dw=native,default=afm16",
    "fp16xbf16": "default=fp16xbf16",
}


def _lm_loss_and_grads(spec, port_spec=None):
    """Reduced granite-3-2b on shared parameters and a shared batch: (port
    loss, JAX loss, [(path, port gradient, JAX gradient)]), the port under
    ``port_spec`` (default: ``spec``) in ``amsim`` (the plain versions on
    the CPU), JAX under ``spec`` in ``amsim_jnp``."""
    cfg = reduced(get_arch("granite-3-2b"))
    jcfg = jax_reduced(jax_get_arch("granite-3-2b"))
    params = jax.tree_util.tree_map(np.asarray, jtransformer.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    jtable = jpolicy.table_from_assignments(spec, default_mode="amsim_jnp")
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.lm_loss(p, jbatch, jcfg, jtable), has_aux=True))(params)
    model = lm_params_from_jax(params, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    loss, _ = lm_loss(model, batch, table_from_assignments(port_spec or spec))
    named = dict(model.named_parameters())
    grads = lm_tree_to_numpy(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
    jl = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    pl = jax.tree_util.tree_leaves(grads)
    assert len(jl) == len(pl)
    return loss.item(), float(jloss), [(jax.tree_util.keystr(path), a, np.asarray(b))
                                       for (path, b), a in zip(jl, pl)]


@pytest.mark.parametrize("name", sorted(SWEEP_TABLES))
def test_lm_loss_and_gradients_under_a_table_match_jax(name):
    """The sweep's objective end to end, port against JAX: the loss to rtol
    1e-5 under both tables.  Gradients: the mixed table (M <= 8) to rtol
    1e-4, atol 1e-6; under fp16xbf16 each gradient leaf within a relative
    L2 error of 3e-3 (measured up to 1.5e-3).  JAX sums each GEMM's
    products in another order (``jnp.sum``; the port folds k in order, as
    the kernels do), and through 2 layers and their backward a 10-bit
    table carries those last-ulp differences across its rounding steps;
    the operand roles themselves are pinned bitwise op by op in
    ``test_torch_fpstages.py``.  The mirrored table (roles swapped) misses
    every leaf by about 1e-2 (measured 9.0e-3 to 1.2e-2), and the loss by
    over 1e-5 (asserted)."""
    spec = SWEEP_TABLES[name]
    loss, jloss, leaves = _lm_loss_and_grads(spec)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for path, a, b in leaves:
        if name == "mixed":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=path)
        else:
            assert np.linalg.norm(a - b) <= 3e-3 * np.linalg.norm(b), path
    if name == "fp16xbf16":
        swapped, jloss, _ = _lm_loss_and_grads(spec, "default=bf16xfp16")
        assert abs(swapped - jloss) > 1e-5 * abs(jloss)


# -------------------------------------------------------- the fault sweep
def _lenet_problem():
    return faultsweep.vision_problem(VISION_REGISTRY["lenet-300-100"], batch=64, lr=0.05, seed=0,
                                     device="cpu", n_train=256, n_test=128)


def test_faultsweep_report(tmp_path):
    out = tmp_path / "fault.json"
    report = faultsweep.main(["--arch", "lenet-300-100", "--device", "cpu", "--steps", "4",
                              "--rates", "0,1e-2,2e-1", "--mode", "amsim", "--multiplier",
                              "afm16", "--out", str(out)])
    assert json.loads(out.read_text())["schema"] == faultsweep.REPORT_SCHEMA
    pts = report["points"]
    assert [p["label"] for p in pts] == ["rate=0", "rate=0.01", "rate=0.2"]
    assert pts[0]["spec"] is None and pts[1]["spec"]["kind"] == "bitflip"
    assert all(p["traces"] == 1 and len(p["losses"]) == 4 for p in pts)
    assert all(0.0 <= p["test_acc"] <= 1.0 and "acc_vs_clean" in p for p in pts)
    assert [p["uploads"] for p in pts] == [1, 1, 1]       # afm16 packed: clean, then each spec
    assert pts[0]["losses"] != pts[2]["losses"]


def test_rate_zero_is_bitwise_the_clean_run():
    """Spec None, a zero-rate spec and a spec aimed at another multiplier
    all run the clean tables: the same losses and accuracy, no upload
    after the first."""
    problem = _lenet_problem()
    pol = NumericsPolicy(mode="amsim", multiplier="afm16")
    runs = [faultsweep.run_fault_point(problem, pol, spec, steps=3) for spec in
            (None, FaultSpec(rate=0.0), FaultSpec(rate=0.5, mult="mitchell8"))]
    for r in runs[1:]:
        assert r["losses"] == runs[0]["losses"] and r["test_acc"] == runs[0]["test_acc"]
        assert r["uploads"] == 0
    assert runs[0]["uploads"] == 1


def test_faulted_point_bitwise_alike_under_amsim_and_amsim_torch():
    """The packed table (``amsim``) and the canonical one (``amsim_torch``)
    fault alike, so a faulted point trains to the same bits."""
    problem = _lenet_problem()
    spec = FaultSpec(kind="bitflip", rate=1e-2, seed=0)
    a, b = (faultsweep.run_fault_point(problem, NumericsPolicy(mode=m, multiplier="afm16"), spec,
                                       steps=3) for m in ("amsim", "amsim_torch"))
    assert a["losses"] == b["losses"] and a["test_acc"] == b["test_acc"]
    assert a["uploads"] == b["uploads"] == 1


def test_ladder_builds_one_step_a_rung():
    """A problem whose loss is NaN off the native path: the supervisor
    rolls back and demotes afm16 -> exact7 -> native, one step built a
    rung (traces == 1 + ladder_level)."""
    base = _lenet_problem()

    def loss(pol):
        inner = base["loss"](pol)

        def fn(model, batch):
            value, metrics = inner(model, batch)
            return (value if pol.is_native else value * float("nan")), metrics
        return fn

    problem = dict(base, loss=loss)
    res = faultsweep.run_fault_point(problem, NumericsPolicy(mode="amsim", multiplier="afm16"),
                                     None, steps=3, ladder=True, max_retries=0)
    assert res["ladder_level"] == 2 and res["traces"] == 3
    assert res["completed_steps"] == 3 and all(np.isfinite(res["losses"]))
    assert {r for _, r, _ in res["divergences"]} == {"non-finite"}


def test_faultsweep_lm_problem():
    report = faultsweep.main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                              "--steps", "1", "--batch", "2", "--seq", "8", "--lr", "3e-4",
                              "--rates", "0,1e-2", "--mode", "amsim_torch", "--multiplier",
                              "afm16"])
    pts = report["points"]
    assert len(pts) == 2 and all(p["traces"] == 1 for p in pts)
    assert "test_acc" not in pts[0] and np.isfinite(pts[1]["final_loss"])

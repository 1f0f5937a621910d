"""The port's sharded execution (``repro_torch.distributed.shard_fused``) on
a 2x2 (data, model) mesh of four gloo ranks on the CPU: the contract rows
of the JAX package's ``tests/test_sharded_fused.py`` (``docs/numerics.md``
"Sharded contracts"), held against the port's single-device ops and the
k-split oracle (each shard's slice through the single-device op, the
partials added in shard order), under ``amsim_torch`` with exact7 and
mitchell8; the kill switch and the dispatch rules; ``shard_tree`` then
``gather_tree``.

The ranks are spawned once for the file (``launch.mesh.spawn``, with a
deadline); each rank runs every check on its blocks and returns its
verdicts, and each check is one case.  The pure-TP pair runs on a (1, 4)
mesh over the same ranks.
"""
import numpy as np
import pytest
import torch

MULTS = ("exact7", "mitchell8")
ROWS = ("column forward bitwise", "row forward == k-split oracle",
        "row forward close to the unsplit product", "column dx == k-split oracle",
        "column dw (batch split) == batch-split oracle", "row dw (batch split) == batch-split oracle",
        "attention forward bitwise", "attention dq dk dv bitwise", "conv forward bitwise",
        "conv dx bitwise", "conv dw == batch-split oracle", "pure-TP pair dW1 dW2 bitwise",
        "pure-TP pair dx close")
OTHERS = ("sharded column forward places no collective", "dispatch takes the sharded path",
          "kill switch: no active mesh", "kill switch: column replicated bitwise",
          "kill switch: row replicated bitwise", "kill switch: attention replicated bitwise",
          "chain off under an active mesh, on under the kill switch",
          "attention_supported: KV heads must divide model", "shard_tree then gather_tree",
          "unsupported spec takes the replicated dispatch",
          "global_norm over split leaves == single-device",
          "adafactor on split leaves == single-device")
CHECKS = [f"{m}: {r}" for m in MULTS for r in ROWS] + list(OTHERS)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _contracts(mesh):
    """Every check on this rank's blocks -> {check: True or a reading}."""
    import os

    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.distributed import shard_fused as sf
    from repro_torch.distributed.sharding import gather_tree, shard_tree
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh

    out = {}
    tp = Mesh((1, 4), device=mesh.device, timeout=mesh.timeout)    # pure tensor parallelism
    rng = np.random.default_rng(0)      # the same draws on every rank

    def rows(t):            # this rank's batch rows
        return mesh.block(t, "data", 0)

    def cols(t, dim=-1):    # this rank's block over "model"
        return mesh.block(t, "model", dim)

    def same(a, b):
        return True if torch.equal(a, b) else f"max|d| {(a - b).abs().max().item():.3g}"

    for mult in MULTS:
        pol = NumericsPolicy(mode="amsim_torch", multiplier=mult)
        leaf = pol.resolve(None)
        x = _t(rng.standard_normal((4, 8, 64)))
        w1 = _t(rng.standard_normal((64, 128)) * 0.1)
        w2 = _t(rng.standard_normal((128, 64)) * 0.1)
        g1 = _t(rng.standard_normal((4, 8, 128)))
        g2 = _t(rng.standard_normal((4, 8, 64)))
        key = f"{mult}: "

        ref = ops.policy_matmul(x, w1, pol)
        got = sf.column_parallel_matmul(rows(x), cols(w1), pol, mesh)
        out[key + ROWS[0]] = same(got, cols(rows(ref)))

        y = ref
        got = sf.row_parallel_matmul(cols(rows(y)), cols(w2, 0), pol, mesh)
        oracle = (ops.policy_matmul(y[..., :64], w2[:64], pol)
                  + ops.policy_matmul(y[..., 64:], w2[64:], pol))
        out[key + ROWS[1]] = same(got, rows(oracle))
        unsplit = rows(ops.policy_matmul(y, w2, pol))
        out[key + ROWS[2]] = bool(torch.allclose(got, unsplit, rtol=1e-5, atol=1e-5)) or \
            f"max|d| {(got - unsplit).abs().max().item():.3g}"

        xl = rows(x).clone().requires_grad_()
        wl = cols(w1).clone().requires_grad_()
        dx, dw = torch.autograd.grad(sf.column_parallel_matmul(xl, wl, pol, mesh), (xl, wl),
                                     cols(rows(g1)))
        dx_oracle = (ops._matmul_nograd(g1[..., :64], w1[:, :64].T, leaf)
                     + ops._matmul_nograd(g1[..., 64:], w1[:, 64:].T, leaf))
        out[key + ROWS[3]] = same(dx, rows(dx_oracle))
        dw_oracle = sf._dw(x[:2], g1[:2], leaf) + sf._dw(x[2:], g1[2:], leaf)
        out[key + ROWS[4]] = same(dw, cols(dw_oracle))

        yl = cols(rows(y)).clone().requires_grad_()
        wl = cols(w2, 0).clone().requires_grad_()
        _, dw = torch.autograd.grad(sf.row_parallel_matmul(yl, wl, pol, mesh), (yl, wl),
                                    rows(g2))
        dw_oracle = sf._dw(y[:2], g2[:2], leaf) + sf._dw(y[2:], g2[2:], leaf)
        out[key + ROWS[5]] = same(dw, cols(dw_oracle, 0))

        B, S, H, KV, dh = 4, 8, 4, 2, 16
        q = _t(rng.standard_normal((B, S, H, dh)))
        k = _t(rng.standard_normal((B, S, KV, dh)))
        v = _t(rng.standard_normal((B, S, KV, dh)))
        pos = torch.arange(S, dtype=torch.int32)
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        aref = ops.policy_attention(*qkv, pos, pos, pol, True, 0)
        gref = torch.autograd.grad((aref ** 2).sum(), qkv)
        loc = [cols(rows(t), 2).clone().requires_grad_() for t in (q, k, v)]
        aout = sf.sharded_attention(*loc, pos, pos, pol, causal=True, window=0)
        out[key + ROWS[6]] = same(aout, cols(rows(aref.detach()), 2))
        gsh = torch.autograd.grad((aout ** 2).sum(), loc)
        out[key + ROWS[7]] = all(torch.equal(a, cols(rows(b), 2)) for a, b in zip(gsh, gref)) \
            or "differ"

        xc = _t(rng.standard_normal((4, 6, 6, 8)))
        wc = _t(rng.standard_normal((3, 3, 8, 16)) * 0.1)
        xr, wr = xc.clone().requires_grad_(), wc.clone().requires_grad_()
        cref = ops.approx_conv2d(xr, wr, 1, "SAME", pol)
        gx_ref, _ = torch.autograd.grad((cref ** 2).sum(), (xr, wr))
        xs, ws = rows(xc).clone().requires_grad_(), wc.clone().requires_grad_()
        cout = sf.sharded_conv2d(xs, ws, 1, "SAME", pol, mesh)
        out[key + ROWS[8]] = same(cout, rows(cref.detach()))
        gx, gw = torch.autograd.grad((cout ** 2).sum(), (xs, ws))
        out[key + ROWS[9]] = same(gx, rows(gx_ref))
        pads = ops.conv_pads(6, 6, 3, 3, 1, "SAME")
        gfull = 2.0 * cref.detach()
        dws = [ops._conv_dw(xc[i:i + 2], wc.shape, gfull[i:i + 2].contiguous(), 1, pads,
                            pol.resolve("conv", pass_="dw")) for i in (0, 2)]
        out[key + ROWS[10]] = same(gw, dws[0] + dws[1])

        xs = _t(rng.standard_normal((3, 4, 64)))    # every rank's whole batch, on (1, 4)
        with tp:
            leaves = [xs.clone().requires_grad_(), tp.block(w1, "model", 1).clone().requires_grad_(),
                      tp.block(w2, "model", 0).clone().requires_grad_()]
            h = sf.column_parallel_matmul(leaves[0], leaves[1], pol, tp)
            gx, gw1, gw2 = torch.autograd.grad(
                (sf.row_parallel_matmul(h, leaves[2], pol, tp) ** 2).sum(), leaves)
        ref_leaves = [t.clone().requires_grad_() for t in (xs, w1, w2)]
        rx, r1, r2 = torch.autograd.grad((ops.policy_matmul(
            ops.policy_matmul(ref_leaves[0], ref_leaves[1], pol), ref_leaves[2], pol) ** 2).sum(),
            ref_leaves)
        out[key + ROWS[11]] = (torch.equal(gw1, tp.block(r1, "model", 1))
                               and torch.equal(gw2, tp.block(r2, "model", 0))) or "differ"
        out[key + ROWS[12]] = bool(torch.allclose(gx, rx, rtol=1e-4, atol=1e-5)) or \
            f"max|d| {(gx - rx).abs().max().item():.3g}"

    # ---- dispatch and the kill switch, under amsim (the plain versions here)
    pol = NumericsPolicy(mode="amsim", multiplier="mitchell8")
    x = _t(rng.standard_normal((4, 8, 64)))
    w1 = _t(rng.standard_normal((64, 128)) * 0.1)
    w2 = _t(rng.standard_normal((128, 64)) * 0.1)
    w1l, w2l = cols(w1).clone(), cols(w2, 0).clone()
    w1l.spec, w2l.spec = (None, "model"), ("model", None)
    before = mesh.stats["collectives"]
    got = sf.parallel_matmul(rows(x), w1l, pol, "column")
    out[OTHERS[0]] = mesh.stats["collectives"] == before or "collectives placed"
    out[OTHERS[1]] = same(got, cols(rows(ops.policy_matmul(x, w1, pol))))
    y = ops.policy_matmul(x, w1, pol)
    os.environ["REPRO_SHARD_FUSED"] = "0"
    try:
        out[OTHERS[2]] = sf.active_mesh(pol.resolve(None)) is None
        got = sf.parallel_matmul(rows(x), w1l, pol, "column")
        out[OTHERS[3]] = same(got, cols(rows(y)))
        got = sf.parallel_matmul(cols(rows(y)), w2l, pol, "row")
        out[OTHERS[4]] = same(got, rows(ops.policy_matmul(y, w2, pol)))
        B, S, H, KV, dh = 4, 8, 4, 2, 16
        q, k, v = (_t(rng.standard_normal((B, S, n, dh))) for n in (H, KV, KV))
        pos = torch.arange(S, dtype=torch.int32)
        aref = ops.policy_attention(q, k, v, pos, pos, pol, True, 0)
        got = sf.parallel_attention(*(cols(rows(t), 2) for t in (q, k, v)), pos, pos, pol,
                                    causal=True, window=0, heads_split=True, mesh=mesh)
        out[OTHERS[5]] = same(got, cols(rows(aref), 2))
        chain_killed = ops.decode_chain_enabled(pol)
    finally:
        del os.environ["REPRO_SHARD_FUSED"]
    out[OTHERS[6]] = (chain_killed and not ops.decode_chain_enabled(pol)) or \
        f"killed {chain_killed}, on {ops.decode_chain_enabled(pol)}"
    out[OTHERS[7]] = (not sf.attention_supported(pol, mesh, (8, 16, 3, 32), (8, 16, 3, 32))
                      and sf.attention_supported(pol, mesh, (8, 16, 4, 32), (8, 16, 2, 32)))
    tree = {"a": x, "b": [w1, (w2, torch.arange(6.0))]}
    specs = {"a": ("data", None, "model"), "b": [(None, "model"), (("model", None), ())]}
    back = gather_tree(shard_tree(tree, specs, mesh), specs, mesh)
    out[OTHERS[8]] = (torch.equal(back["a"], x) and torch.equal(back["b"][0], w1)
                      and torch.equal(back["b"][1][0], w2)
                      and torch.equal(back["b"][1][1], tree["b"][1][1]))
    w_moved = w1.clone()      # a spec moved off the parallel dim: whole on every rank
    w_moved.spec = (None, None)
    got = sf.parallel_matmul(rows(x), w_moved, pol, "column")
    out[OTHERS[9]] = same(got, rows(y))

    from repro_torch.optim.optimizers import adafactor, global_norm
    full = {"w": _t(rng.standard_normal((6, 8))), "g": _t(rng.standard_normal(8)),
            "v": _t(rng.standard_normal((4, 6)))}
    grads = {k: v * 0.3 + 0.1 for k, v in full.items()}
    specs = {"w": (None, "model"), "g": (), "v": ("model", None)}
    local = {k: mesh.block(v, "model", 1 if k == "w" else 0) if specs[k] else v
             for k, v in full.items()}
    lgrads = {k: mesh.block(v, "model", 1 if k == "w" else 0) if specs[k] else v
              for k, v in grads.items()}
    ref = global_norm(grads)
    got = global_norm(lgrads, specs)
    out[OTHERS[10]] = bool(torch.allclose(got, ref, rtol=1e-6)) or f"{got} vs {ref}"
    opt = adafactor(1e-2)
    for k, v in local.items():
        v.spec = specs[k]
    upd, _ = opt.update(lgrads, opt.init(local), local)
    from repro_torch.launch.mesh import single_device
    with single_device():
        rupd, _ = opt.update(grads, opt.init(full), full)
    ok = all(torch.allclose(upd[k], mesh.block(rupd[k], "model", 1 if k == "w" else 0)
                            if specs[k] else rupd[k], rtol=1e-5, atol=1e-7) for k in full)
    out[OTHERS[11]] = ok or {k: (upd[k] - (mesh.block(rupd[k], "model", 1 if k == "w" else 0)
                                           if specs[k] else rupd[k])).abs().max().item()
                             for k in full}
    return out


@pytest.fixture(scope="module")
def verdicts():
    from repro_torch.launch.mesh import spawn
    ranks = spawn(_contracts, (2, 2), device="cpu", timeout=300)
    return {c: [r[c] for r in ranks] for c in CHECKS}


@pytest.mark.parametrize("check", CHECKS)
def test_sharded_contract(verdicts, check):
    """Each check holds on every rank of the 2x2 mesh (a reading where not)."""
    assert all(v is True for v in verdicts[check]), verdicts[check]

"""The port's continuous batching against the JAX package's.

Per-row positions first: the mask, the einsum lowering and the attention
kernel's plain version with (B, S) / (B, T) positions against JAX's; rope
and attention with per-row positions that agree across rows give the bits
of shared positions; the attention backward with per-row positions at a
length that chunks.  Then the whole scheduler: the port's
``ContinuousBatchingEngine`` and JAX's on the same ragged two-tier stream
(``native``, and ``amsim_torch`` against ``amsim_jnp``), dense and MoE,
with a pool small enough to preempt, and with a bfloat16 cache: the same
tokens, statuses and preemptions.  Then the twins of
``tests/test_scheduler.py`` (the port's engine against the port's own B=1
``ServingEngine``), of ``test_cbe_paged_moe_chain`` and
``test_cbe_decode_ticks_zero_added_retraces`` (a count of the chain
entries' calls in place of JAX's trace counter), the kill switches and the
CLI.  Sizes: ``reduced(..., n_layers=1)``.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.common import attention_mask as jax_attention_mask  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import scheduler as jscheduler  # noqa: E402
from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.approx_attention import approx_attention_plain  # noqa: E402
from repro_torch.kernels.common import POS_PAD, attention_mask, lut_tensor  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models.transformer import (init_lm_caches, init_paged_lm_caches,  # noqa: E402
                                            lm_forward)
from repro_torch.serve import (ContinuousBatchingEngine, PageAllocator,  # noqa: E402
                               ServingEngine, pages_for)
from repro_torch.serve.scheduler import _merge_control  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The scheduler's steps are many small ops: on a CPU shared with other
    test processes they run fastest on one thread (restored after the
    module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        yield


MULT = "afm16"
NATIVE = NumericsPolicy()
AMSIM_T = NumericsPolicy(mode="amsim_torch", multiplier=MULT)
TIERS = {"exact": (NATIVE, JaxPolicy()),
         "cheap": (AMSIM_T, JaxPolicy(mode="amsim_jnp", multiplier=MULT))}
ARCHS = {"dense": "granite-3-2b", "moe": "granite-moe-3b-a800m"}


def _cfgs(family, **kw):
    return (reduced(get_arch(ARCHS[family]), n_layers=1, **kw),
            jax_reduced(jax_get_arch(ARCHS[family]), n_layers=1, **kw))


@pytest.fixture(scope="module")
def carried():
    """family -> (JAX params as numpy, the port's model on the CPU)."""
    out = {}
    for family in ARCHS:
        cfg, jcfg = _cfgs(family)
        params = jax.tree_util.tree_map(np.asarray,
                                        jtransformer.init_lm(jax.random.PRNGKey(7), jcfg))
        out[family] = (params, lm_params_from_jax(params, cfg, device="cpu"))
    return out


@pytest.fixture(scope="module")
def model(carried):
    return carried["dense"][1]


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in lengths]


# ------------------------------------------------------- per-row positions
def _rows_positions(B=3, S=4, T=12, seed=0):
    """Per-row positions of a paged decode batch: each row at its own
    start, keys valid up to start + S, one dead row (every key unwritten)."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, T - S, size=B).astype(np.int32)
    q_pos = start[:, None] + np.arange(S, dtype=np.int32)[None]
    t = np.arange(T, dtype=np.int32)[None]
    live = np.ones(B, bool)
    live[-1] = False
    k_pos = np.where(live[:, None] & (t < (start + S)[:, None]), t, POS_PAD).astype(np.int32)
    return q_pos, k_pos


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_attention_mask_per_row_matches_jax(causal, window):
    q_pos, k_pos = _rows_positions()
    got = attention_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos), causal=causal,
                         window=window)
    want = jax_attention_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), causal=causal,
                              window=window)
    assert got.shape == (3, 4, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _attention_inputs(seed=1, B=3, S=4, H=4, KV=2, dh=16, T=12):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    return q, k, v


def _live_rows(x, q_pos, k_pos):
    """The rows that have a valid key: the others carry no context under any
    lowering (the port's lowerings return the mean of V there, JAX's kernel
    zeros), so no comparison across packages reads them."""
    return x[(k_pos >= 0).any(axis=1)]


@pytest.mark.parametrize("window", [0, 3])
def test_per_row_attention_matches_jax(window):
    """(B, S) / (B, T) positions: the port's einsum lowering under
    ``amsim_torch`` and the kernel's plain version against JAX
    ``attend_einsum`` under ``amsim_jnp`` (atol=rtol=1e-5: the softmax
    denominator is summed in the warp order here and in XLA's there, an ulp
    apart at most, which a LUT product can carry one truncation step; see
    tests/test_torch_attention.py), and under ``native`` against JAX
    ``native`` (the same bound: sum orders); the lowering and the plain
    version bitwise."""
    q, k, v = _attention_inputs()
    q_pos, k_pos = _rows_positions()
    kw = dict(causal=True, window=window)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    j = [jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)]
    lut = lut_tensor(lutgen.get_lut(MULT), "cpu")
    M = lutgen.get_multiplier(MULT).mantissa_bits
    plain = approx_attention_plain(*t, lut, M, **kw)
    einsum = ops.attend_einsum(*t, AMSIM_T, **kw)
    assert torch.equal(plain, einsum)
    ref = np.asarray(jops.attend_einsum(*j, TIERS["cheap"][1], **kw))
    np.testing.assert_allclose(_live_rows(plain.numpy(), q_pos, k_pos),
                               _live_rows(ref, q_pos, k_pos), rtol=1e-5, atol=1e-5)
    nat = ops.attend_einsum(*t, NATIVE, **kw).numpy()
    ref = np.asarray(jops.attend_einsum(*j, JaxPolicy(), **kw))
    np.testing.assert_allclose(_live_rows(nat, q_pos, k_pos), _live_rows(ref, q_pos, k_pos),
                               rtol=1e-5, atol=1e-5)


def test_per_row_positions_that_agree_give_the_shared_bits():
    """Positions repeated across the batch rows take the same arithmetic as
    one shared vector: rope, the plain version and the einsum lowering, bit
    for bit."""
    q, k, v = [torch.from_numpy(a) for a in _attention_inputs(seed=2)]
    B, S, T = q.shape[0], q.shape[1], k.shape[1]
    q_pos = torch.arange(T - S, T, dtype=torch.int32)
    k_pos = torch.arange(T, dtype=torch.int32)
    rows = q_pos.expand(B, S).contiguous(), k_pos.expand(B, T).contiguous()
    assert torch.equal(attn_mod.rope(q, rows[0], 1e4), attn_mod.rope(q, q_pos, 1e4))
    lut = lut_tensor(lutgen.get_packed_lut(MULT), "cpu")
    M = lutgen.get_multiplier(MULT).mantissa_bits
    for kw in (dict(causal=True, window=0), dict(causal=True, window=5)):
        assert torch.equal(approx_attention_plain(q, k, v, *rows, lut, M, **kw),
                           approx_attention_plain(q, k, v, q_pos, k_pos, lut, M, **kw))
        assert torch.equal(ops.attend_einsum(q, k, v, *rows, AMSIM_T, **kw),
                           ops.attend_einsum(q, k, v, q_pos, k_pos, AMSIM_T, **kw))


def test_per_row_attention_gradient_at_a_length_that_chunks(monkeypatch):
    """The fused attention's backward recomputes (B, S) positions in one,
    not a query chunk at a time (its chunks would slice the positions'
    batch axis): at S = 128 with a chunk of 64 the gradients of
    ``policy_attention`` are bit for bit those of ``attend_einsum`` under
    autograd, and with 1-D positions the chunked ones are within 1e-6 of
    them (dk and dv summed over chunks in another order)."""
    monkeypatch.setattr(ops, "_BWD_Q_CHUNK", 64)
    rng = np.random.default_rng(3)
    B, S, H, KV, dh = 2, 128, 2, 1, 8
    q = torch.from_numpy(rng.standard_normal((B, S, H, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KV, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, dh)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, S, H, dh)).astype(np.float32))
    policy = NumericsPolicy(mode="amsim", multiplier=MULT)
    shared = torch.arange(S, dtype=torch.int32)
    for q_pos, exact in ((shared.expand(B, S).contiguous(), True), (shared, False)):
        k_pos = q_pos

        def grads(fn):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            fn(*leaves).backward(g)
            return [t.grad for t in leaves]

        got = grads(lambda a, b, c: ops.policy_attention(a, b, c, q_pos, k_pos, policy, True, 0))
        want = grads(lambda a, b, c: ops.attend_einsum(a, b, c, q_pos, k_pos, policy,
                                                       causal=True, window=0))
        for a, b in zip(got, want):
            if exact:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------- the engine vs JAX
def _stream(vocab, n=6, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, vocab, size=int(rng.integers(3, 10))).tolist()
        out.append((i, prompt, 8, sorted(TIERS)[i % 2]))
    return out


def _run_both(family, carried, cfgs, **engine_kw):
    """The port's engine and JAX's on one stream: their finished requests
    by rid."""
    params, model = carried[family]
    cfg, jcfg = cfgs
    if cfg is not model.cfg:
        model = lm_params_from_jax(params, cfg, device="cpu")
    stream = _stream(cfg.vocab)
    eng = ContinuousBatchingEngine(model, {n: p for n, (p, _) in TIERS.items()}, **engine_kw)
    eng.run(stream)
    jeng = jscheduler.ContinuousBatchingEngine(
        jcfg, {n: p for n, (_, p) in TIERS.items()}, jax.tree_util.tree_map(jnp.asarray, params),
        **engine_kw)
    jeng.run(stream)
    return eng, jeng


def _same_outcome(eng, jeng):
    assert sorted(eng.finished) == sorted(jeng.finished)
    for rid, req in eng.finished.items():
        jreq = jeng.finished[rid]
        assert (req.out, req.status, req.preemptions, req.tier) == \
            (jreq.out, jreq.status, jreq.preemptions, jreq.tier), f"request {rid}"


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_engine_matches_jax_on_a_ragged_two_tier_stream(carried, family):
    """Six requests, prompts of 3-9 tokens and 8 new tokens, one arrival a
    tick, tiers ``exact`` (native) and ``cheap`` (amsim_torch / amsim_jnp)
    in turn, capacity 2 a lane over 4-token pages and a pool of 5: preemption
    happens, and the port emits JAX's tokens with JAX's statuses and
    preemption counts.  The MoE stream is held against JAX's scheduler on
    the same stream (dead slots take expert capacity in both)."""
    eng, jeng = _run_both(family, carried, _cfgs(family), max_len=24, capacity=2,
                          page_size=4, n_pages=5)
    _same_outcome(eng, jeng)
    assert sum(r.preemptions for r in eng.finished.values()) > 0
    assert eng.decode_trace_counts == {"exact": 1, "cheap": 1}
    assert eng.n_free_pages == {"exact": 4, "cheap": 4}


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_trash_page_stays_zero(carried, family):
    """Every write that lands on the trash page carries zeros: dead slots'
    writes, and a padded prefill's tail past the pages it was given (a
    17-token prompt runs in a bucket of 32 over pages of 4: positions 20-31
    sit on unallocated entries).  Page 0 of every pool is zero after the
    stream (exactly), so a dead row reads the same keys on every run."""
    cfg = _cfgs(family)[0]
    stream = [(i, p, 4, "cheap") for i, p in enumerate(_prompts(cfg.vocab, (17, 5, 9), seed=5))]
    eng = ContinuousBatchingEngine(carried[family][1], {"cheap": AMSIM_T}, max_len=40,
                                   capacity=3, page_size=4)
    eng.run(stream)
    assert all(r.status == "ok" for r in eng.finished.values())
    assert 32 in eng._lanes["cheap"].prefill_buckets
    for layer in eng._lanes["cheap"].caches:
        for pool in (layer["pool_k"], layer["pool_v"]):
            assert torch.count_nonzero(pool[0]) == 0
            assert torch.count_nonzero(pool[1:]) > 0


def test_bf16_cache_matches_jax(carried):
    """``cache_dtype="bfloat16"``: K/V stored in bfloat16 (rounded to
    nearest even in both packages) and read as float32; the same tokens."""
    cfgs = _cfgs("dense", cache_dtype="bfloat16")
    eng, jeng = _run_both("dense", carried, cfgs, max_len=24, capacity=2, page_size=4)
    _same_outcome(eng, jeng)
    pools = next(iter(eng._lanes.values())).caches[0]
    assert pools["pool_k"].dtype == torch.bfloat16
    assert init_lm_caches(cfgs[0], 1, 8, "cpu")[0]["k"].dtype == torch.bfloat16


# ------------------------------------------ twins of tests/test_scheduler.py
def _oracle(model, policy, prompts, new, max_len=32):
    """The port's ring engine, one request at a time (B=1)."""
    eng = ServingEngine(model, policy, max_len=max_len)
    return [eng.generate(torch.tensor([p]), max_new_tokens=new)[0].tolist() for p in prompts]


def test_page_allocator_contract():
    a = PageAllocator(5)  # pages 1..4 usable, 0 = trash
    assert a.capacity == 4
    got = a.alloc(4)
    assert sorted(got) == [1, 2, 3, 4]
    assert a.alloc(1) is None          # all-or-nothing exhaustion
    a.release([got[0]])
    with pytest.raises(ValueError):
        a.release([got[0]])            # double free
    with pytest.raises(ValueError):
        a.release([0])                 # the trash page is never allocatable
    assert pages_for(0, 4) == 0 and pages_for(1, 4) == 1
    assert pages_for(4, 4) == 1 and pages_for(5, 4) == 2


@pytest.mark.parametrize("policy", [NATIVE, AMSIM_T], ids=["native", "amsim_torch"])
def test_paged_vs_ring_bit_identity(model, policy):
    """A single resident request decoding through the paged cache gives the
    ring cache's logits bit for bit: the pages laid out in position order
    give the ring's (B, T, KV, dh) view, and the per-row positions agree
    with the ring's shared ones."""
    cfg = model.cfg
    max_len, ps = 16, 4
    prompt = torch.tensor([_prompts(cfg.vocab, [6])[0]])
    m = prompt.shape[1]
    ring = init_lm_caches(cfg, 1, max_len, "cpu")
    lr, ring, _ = lm_forward(model, prompt, policy, caches=ring)
    pools = init_paged_lm_caches(cfg, max_len // ps + 1, ps, "cpu")
    ptab = torch.arange(1, max_len // ps + 1, dtype=torch.int32)[None]
    live = torch.ones((1,), dtype=torch.bool)
    lp, _, _ = lm_forward(model, prompt, policy,
                          caches=_merge_control(pools, ptab, live,
                                                torch.zeros((1,), dtype=torch.int32)))
    assert torch.equal(lr[:, -1], lp[:, -1])
    tok_r = tok_p = torch.argmax(lp[:, -1:], dim=-1).to(torch.int32)
    for i in range(4):
        lr, ring, _ = lm_forward(model, tok_r, policy, caches=ring)
        lp, _, _ = lm_forward(model, tok_p, policy, caches=_merge_control(
            pools, ptab, live, torch.full((1,), m + i, dtype=torch.int32)))
        assert torch.equal(lr, lp), f"decode step {i}"
        tok_r = torch.argmax(lr[:, -1:], dim=-1).to(torch.int32)
        tok_p = torch.argmax(lp[:, -1:], dim=-1).to(torch.int32)


def test_ragged_stream_matches_uniform_engine(model):
    """Ragged prompts through the scheduler (bucketed prefill, staggered
    retirement) == the B=1 ring engine, token for token."""
    prompts = _prompts(model.cfg.vocab, (5, 3, 7, 4))
    want = _oracle(model, NATIVE, prompts, 6)
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=2, page_size=4)
    rids = [cbe.submit(p, 6) for p in prompts]
    out = cbe.drain()
    assert [out[r] for r in rids] == want
    assert cbe.decode_trace_counts == {"default": 1}
    assert cbe.prefill_trace_counts["default"] <= 2   # at most one a bucket
    assert cbe.n_free_pages["default"] == cbe.n_pages - 1


def test_capacity_one_and_single_token_requests(model):
    """A lane of one slot (pure sequential), and max_new_tokens=1 requests
    that retire straight out of prefill without ever decoding."""
    prompts = _prompts(model.cfg.vocab, (5, 3), seed=1)
    want = _oracle(model, NATIVE, prompts, 5)
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=1, page_size=4)
    rids = [cbe.submit(p, 5) for p in prompts]
    out = cbe.drain()
    assert [out[r] for r in rids] == want
    cbe1 = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=2, page_size=4)
    rids = [cbe1.submit(p, 1) for p in prompts]
    out = cbe1.drain()
    assert [out[r] for r in rids] == [w[:1] for w in want]
    assert cbe1.decode_trace_counts == {"default": 0}  # never decoded


def test_mixed_tier_stream_matches_per_tier_engines(model):
    """Requests of two tiers through ONE scheduler == each tier served alone
    by a B=1 engine under its policy; each tier's decode step built once."""
    tiers = {"exact": NATIVE, "cheap": AMSIM_T}
    prompts = _prompts(model.cfg.vocab, (5, 4, 6, 3), seed=2)
    names = ["exact", "cheap", "exact", "cheap"]
    want = {}
    for tname, tpol in tiers.items():
        mine = [p for p, n in zip(prompts, names) if n == tname]
        for p, o in zip(mine, _oracle(model, tpol, mine, 6)):
            want[tuple(p)] = o
    cbe = ContinuousBatchingEngine(model, tiers, max_len=32, capacity=2, page_size=4)
    rids = [cbe.submit(p, 6, tier=n) for p, n in zip(prompts, names)]
    out = cbe.drain()
    for rid, p in zip(rids, prompts):
        assert out[rid] == want[tuple(p)], f"request {rid} ({p})"
    assert cbe.decode_trace_counts == {"exact": 1, "cheap": 1}


def test_preemption_by_recompute_is_token_identical(model):
    """An overcommitted pool forces eviction mid-flight; evicted requests
    resume by re-prefilling prompt ++ emitted and land on the same
    continuation."""
    prompts = _prompts(model.cfg.vocab, (6, 4, 9), seed=3)
    want = _oracle(model, NATIVE, prompts, 8)
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=3, page_size=4,
                                   n_pages=7)
    rids = [cbe.submit(p, 8) for p in prompts]
    out = cbe.drain()
    assert [out[r] for r in rids] == want
    assert sum(r.preemptions for r in cbe.finished.values()) > 0, \
        "pool was sized to force preemption but none happened"
    assert cbe.decode_trace_counts == {"default": 1}


def test_windowed_stream_recycles_pages(model):
    """Sliding-window serving releases slid-out pages mid-flight: a
    40-token stream runs inside a 4-page pool (16 positions) and matches
    the windowed full-recompute oracle."""
    cfgw = dataclasses.replace(model.cfg, sliding_window=8)
    prompt = _prompts(model.cfg.vocab, [5], seed=4)[0]
    toks = list(prompt)
    mw = copy.copy(model)           # the same weights under the windowed config
    mw.cfg = cfgw
    for _ in range(40):
        lg, _, _ = lm_forward(mw, torch.tensor([toks]), NATIVE)
        toks.append(int(torch.argmax(lg[0, -1])))
    cbe = ContinuousBatchingEngine(mw, NATIVE, max_len=64, capacity=1, page_size=4, n_pages=5)
    rid = cbe.submit(prompt, 40)
    assert cbe.drain()[rid] == toks[len(prompt):]
    assert cbe.n_free_pages["default"] == 4  # everything released
    assert cbe.pages_high["default"] <= 4


def test_submit_validation(model):
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=16, capacity=2, page_size=4)
    with pytest.raises(ValueError, match="empty"):
        cbe.submit([], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        cbe.submit([1, 2], 0)
    with pytest.raises(ValueError, match="tier"):
        cbe.submit([1, 2], 4, tier="nope")
    with pytest.raises(ValueError, match="max_len"):
        cbe.submit(list(range(1, 14)), 4)      # 13 + 4 > 16
    rid = cbe.submit(list(range(1, 13)), 4)    # 12 + 4 == 16: admissible
    assert len(cbe.drain()[rid]) == 4
    small = ContinuousBatchingEngine(model, NATIVE, max_len=16, capacity=1, page_size=4,
                                     n_pages=3)
    with pytest.raises(ValueError, match="pages"):
        small.submit(list(range(1, 11)), 6)


# -------------------------------- twins of tests/test_decode_chain.py's CBE tests
CHAIN_ENTRIES = ("decode_qkv", "decode_attn_out_mlp", "decode_out_mlp_b", "decode_wo_norm",
                 "decode_moe_ffn")


def _count_chain(monkeypatch):
    """A count of the chain entries' calls (each launches a chain kernel
    under ``amsim`` on the card)."""
    calls = {}
    for name in CHAIN_ENTRIES:
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _fn(*a, **k))[1])
    return calls


def test_cbe_paged_moe_chain(carried, monkeypatch):
    """MoE decode through the engine's paged ticks: the chain engages (qkv,
    wo+norm and the expert banks each tick) and the tokens equal a
    chain-off engine's (``REPRO_DECODE_FUSED=0``, which calls no entry)."""
    model = carried["moe"][1]
    policy = NumericsPolicy(mode="amsim", multiplier=MULT)
    prompts = _prompts(model.cfg.vocab, (5, 3), seed=7)
    calls = _count_chain(monkeypatch)

    def run():
        cbe = ContinuousBatchingEngine(model, {"t": policy}, max_len=32, capacity=2,
                                       page_size=4)
        rids = [cbe.submit(p, 5, tier="t") for p in prompts]
        out = cbe.drain()
        return [out[r] for r in rids], cbe.decode_ticks["t"]

    fused, ticks = run()
    assert calls["decode_qkv"] == calls["decode_wo_norm"] == ticks * model.cfg.n_layers
    assert calls["decode_moe_ffn"] >= ticks * model.cfg.n_layers
    before = dict(calls)
    monkeypatch.setenv("REPRO_DECODE_FUSED", "0")
    perop, _ = run()
    assert calls == before, "the per-op path called a chain entry"
    assert fused == perop, "the paged MoE chain changed the tokens"


def test_cbe_decode_ticks_add_no_builds(model, monkeypatch):
    """An ``amsim`` tier's decode ticks run the chain (2-launch form: a
    table of 8 pages of 4 slots), and a second wave through the same engine
    builds no new decode step."""
    calls = _count_chain(monkeypatch)
    policy = NumericsPolicy(mode="amsim", multiplier=MULT)
    prompts = _prompts(model.cfg.vocab, (5, 3, 6, 4), seed=4)
    cbe = ContinuousBatchingEngine(model, {"cheap": policy}, max_len=32, capacity=2,
                                   page_size=4)
    rids = [cbe.submit(p, 5, tier="cheap") for p in prompts[:2]]
    out = cbe.drain()
    assert all(len(out[r]) == 5 for r in rids)
    ticks = cbe.decode_ticks["cheap"]
    assert calls == {"decode_qkv": ticks, "decode_attn_out_mlp": ticks}
    assert cbe.decode_trace_counts == {"cheap": 1}
    rids2 = [cbe.submit(p, 4, tier="cheap") for p in prompts[2:]]
    out2 = cbe.drain()
    assert all(len(out2[r]) == 4 for r in rids2)
    assert cbe.decode_trace_counts == {"cheap": 1}, "the second wave rebuilt the decode step"
    assert calls["decode_qkv"] == cbe.decode_ticks["cheap"]


# ------------------------------------------------ recompute reproduces decode
@pytest.mark.parametrize("mode", ["amsim", "amsim_torch"])
def test_prefill_reproduces_the_decode_chain_bitwise(model, monkeypatch, mode):
    """Under a chain leaf a serving forward normalises in the chain's order,
    so a prefill over prompt ++ emitted gives, at its last position, the
    logits the decode chain gave for that token, bit for bit (what makes
    preemption by recompute token-identical), and the per-op decode path
    (``REPRO_DECODE_FUSED=0``) the chain's logits."""
    policy = NumericsPolicy(mode=mode, multiplier=MULT)
    prompt = torch.tensor([_prompts(model.cfg.vocab, [7], seed=9)[0]])
    engine = ServingEngine(model, policy, max_len=32)
    toks, logits = engine.generate(prompt, 4, return_logits=True)
    full = torch.cat([prompt, toks[:, :3].long()], dim=1)
    recomputed, _, _ = lm_forward(model, full, policy,
                                  caches=init_lm_caches(model.cfg, 1, 32, "cpu"))
    assert torch.equal(recomputed[:, -1], logits[:, -1])
    monkeypatch.setenv("REPRO_DECODE_FUSED", "0")
    _, per_op = ServingEngine(model, policy, max_len=32).generate(prompt, 4,
                                                                  return_logits=True)
    assert torch.equal(per_op, logits)
    # The block norms themselves: the chain's order with a cache, the
    # model's own in training (rows where the two orders differ by an ulp).
    from repro_torch.kernels.decode_chain import rmsnorm_lanes
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import _block_norm
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 512)).astype(np.float32))
    n1 = model.layers[0].n1
    assert torch.equal(_block_norm(policy, {})(n1, x[:, :128], 1e-5),
                       rmsnorm_lanes(x[:, :128], n1.g, 1e-5))
    assert _block_norm(policy, None) is rmsnorm
    assert not torch.equal(rmsnorm_lanes(x, torch.ones(512), 1e-5),
                           ops.rmsnorm_expr(x, torch.ones(512), 1e-5))


# ---------------------------------------------------------- kill switches
def _decode_entries(model, monkeypatch, env, T):
    """The chain entries one paged decode tick of ``model`` calls under
    ``amsim`` with the environment ``env``, over a table of T slots."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = _count_chain(monkeypatch)
    fused_attn = []
    orig = ops.policy_attention
    monkeypatch.setattr(attn_mod, "policy_attention",
                        lambda *a, **k: (fused_attn.append(1), orig(*a, **k))[1])
    policy = NumericsPolicy(mode="amsim", multiplier=MULT)
    cbe = ContinuousBatchingEngine(model, policy, max_len=T, capacity=2, page_size=4)
    cbe.submit([1, 2, 3], 2)
    cbe.step()          # admission (prefill) and one decode tick
    return {k: v for k, v in calls.items() if v}, len(fused_attn)


@pytest.mark.parametrize("env,want", [
    ({}, ({"decode_qkv": 1, "decode_attn_out_mlp": 1}, 1)),
    ({"REPRO_DECODE_FUSED": "0"}, ({}, 2)),
    ({"REPRO_DECODE_FUSE_ATTN": "0"}, ({"decode_qkv": 1, "decode_out_mlp_b": 1}, 2)),
    ({"REPRO_ATTN_FUSED": "0"}, ({"decode_qkv": 1, "decode_out_mlp_b": 1}, 0)),
], ids=["default", "decode_fused_off", "fuse_attn_off", "attn_fused_off"])
def test_kill_switches_pick_their_decode_path(model, monkeypatch, env, want):
    """Default: the 2-launch chain (the prefill's attention takes the fused
    kernel).  ``REPRO_DECODE_FUSED=0``: the per-op path (no chain entry; the
    decode's attention takes the kernel too).  ``REPRO_DECODE_FUSE_ATTN=0``:
    the 3-launch form.  ``REPRO_ATTN_FUSED=0``: the 3-launch form with the
    attention as the einsum lowering, at prefill too."""
    assert _decode_entries(model, monkeypatch, env, 32) == want


def test_kill_switches_keep_the_tokens(model, monkeypatch):
    """Every switch changes the path, never the tokens (``amsim`` on the
    CPU runs the plain versions, whose arithmetic every path shares)."""
    prompts = _prompts(model.cfg.vocab, (5, 9), seed=6)
    policy = NumericsPolicy(mode="amsim", multiplier=MULT)
    runs = []
    for name in ("", "REPRO_DECODE_FUSED", "REPRO_DECODE_FUSE_ATTN", "REPRO_ATTN_FUSED"):
        with monkeypatch.context() as mp:
            if name:
                mp.setenv(name, "0")
            cbe = ContinuousBatchingEngine(model, policy, max_len=24, capacity=2, page_size=4)
            rids = [cbe.submit(p, 4) for p in prompts]
            out = cbe.drain()
            runs.append([out[r] for r in rids])
    assert all(r == runs[0] for r in runs[1:])


def test_conv_kill_switch_runs_im2col(monkeypatch):
    """``REPRO_CONV_FUSED=0``: an ``amsim`` conv forward, dx and dw leave the
    conv kernels for im2col and the GEMM kernel (on the CPU both give the
    plain versions' products; the im2col sum order differs, atol=rtol=1e-5)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 4)).astype(np.float32))
    policy = NumericsPolicy(mode="amsim", multiplier=MULT)
    seen = []
    for name in ("approx_conv2d_fused", "approx_conv2d_dw", "conv2d_im2col"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **k: (
            seen.append(_n), _fn(*a, **k))[1])

    def run():
        seen.clear()
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = ops.approx_conv2d(xl, wl, 1, "SAME", policy)
        y.sum().backward()
        return y.detach(), xl.grad, wl.grad, sorted(set(seen))

    *fused, path = run()
    assert path == ["approx_conv2d_dw", "approx_conv2d_fused"]
    monkeypatch.setenv("REPRO_CONV_FUSED", "0")
    *im2col, path = run()
    assert path == ["conv2d_im2col"]
    for a, b in zip(fused, im2col):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- CLI
def test_serve_cli_stream_on_the_cpu(capsys):
    engine = serve_cli.main(["--stream", "4", "--reduced", "--device", "cpu", "--tiers",
                             "exact=native,cheap=amsim:afm16", "--capacity", "2",
                             "--page-size", "8", "--prompt-len", "12", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "stream: 4 requests, 16 tokens" in out
    assert "decode builds: {'exact': 1, 'cheap': 1}" in out
    assert engine.decode_trace_counts == {"exact": 1, "cheap": 1}
    assert all(len(r.out) == 4 and r.status == "ok" for r in engine.finished.values())


def test_serve_cli_batch_and_refusals(capsys):
    serve_cli.main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "5",
                    "--new-tokens", "3", "--numerics", "amsim_torch", "--multiplier", MULT])
    assert "generated (2, 3)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="later slice"):
        serve_cli.main(["--reduced", "--device", "cpu", "--mesh", "--stream", "4"])
    with pytest.raises(SystemExit, match="unknown mode"):
        serve_cli.parse_tiers("cheap=amsim_jnp:afm16")
    assert set(serve_cli.parse_tiers("a=native,b=amsim_torch:afm16")) == {"a", "b"}

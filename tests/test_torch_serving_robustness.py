"""Fault-aware serving in the port (``serve/scheduler.py``): the twins of
``tests/test_serving_robustness.py`` -- per-request deadlines,
non-finite-logit quarantine, and re-admission on a stronger tier through
``fault_retier`` -- at ``reduced(granite-3-2b, n_layers=1)``, with the
JAX package's parameters carried across."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingEngine  # noqa: E402

NATIVE = NumericsPolicy()
AMSIM_T = NumericsPolicy(mode="amsim_torch", multiplier="afm16")
TIERS = {"exact": NATIVE, "cheap": AMSIM_T}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The scheduler's steps are many small ops: on a CPU shared with other
    test processes they run fastest on one thread (restored after the
    module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_arch("granite-3-2b"), n_layers=1)
    params = jtransformer.init_lm(jax.random.PRNGKey(7),
                                  jax_reduced(jax_get_arch("granite-3-2b"), n_layers=1))
    return lm_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in lengths]


def _poison(lane, attr):
    """Wrap a lane's decode step (``"step"``) or prefill so that every slot
    reports non-finite logits: a deterministic stand-in for a faulty
    datapath."""
    orig = getattr(lane, attr)

    def bad(*a):
        nxt, ok, caches = orig(*a)
        return nxt, torch.zeros_like(ok), caches
    setattr(lane, attr, bad)


# -------------------------------------------------------------- deadlines
def test_deadline_validation(model):
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=1, page_size=4)
    with pytest.raises(ValueError, match="deadline"):
        cbe.submit(_prompts(model.cfg.vocab, [4])[0], 4, deadline=0)


def test_queued_deadline_expires(model):
    """capacity=1: the second request starves behind the first and its
    deadline lapses while still queued: retired with no tokens."""
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=1, page_size=4)
    p1, p2 = _prompts(model.cfg.vocab, [6, 6])
    r1 = cbe.submit(p1, 12)
    r2 = cbe.submit(p2, 4, deadline=2)
    out = cbe.drain()
    assert len(out[r1]) == 12
    assert cbe.finished[r1].status == "ok"
    assert cbe.finished[r2].status == "deadline"
    assert out[r2] == []                        # never ran a single step


def test_resident_deadline_partial_output(model):
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=64, capacity=1, page_size=4)
    p = _prompts(model.cfg.vocab, [6])[0]
    rid = cbe.submit(p, 20, deadline=4)
    out = cbe.drain()
    assert cbe.finished[rid].status == "deadline"
    assert 0 < len(out[rid]) < 20               # partial, honest output
    # The emitted prefix matches an undeadlined run token for token.
    cbe2 = ContinuousBatchingEngine(model, NATIVE, max_len=64, capacity=1, page_size=4)
    r2 = cbe2.submit(p, 20)
    full = cbe2.drain()[r2]
    assert out[rid] == full[:len(out[rid])]


def test_no_deadline_unchanged(model):
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=2, page_size=4)
    rids = [cbe.submit(p, 6) for p in _prompts(model.cfg.vocab, [5, 9])]
    out = cbe.drain()
    assert all(len(out[r]) == 6 for r in rids)
    assert all(cbe.finished[r].status == "ok" for r in rids)


# ------------------------------------------------------------- quarantine
def test_decode_fault_quarantines_without_retier(model):
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=2, page_size=4)
    rid = cbe.submit(_prompts(model.cfg.vocab, [6])[0], 8)
    _poison(cbe._lanes["default"], "step")
    out = cbe.drain()
    assert cbe.finished[rid].status == "fault"
    assert len(out[rid]) == 1                   # the prefill token only
    lane = cbe._lanes["default"]                # slots and pages released
    assert not lane.ctrl.live.any()
    assert lane.alloc.capacity == lane.alloc.n_free


def test_prefill_fault_quarantines(model):
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=2, page_size=4)
    rid = cbe.submit(_prompts(model.cfg.vocab, [6])[0], 8)
    _poison(cbe._lanes["default"], "prefill")
    out = cbe.drain()
    assert cbe.finished[rid].status == "fault"
    assert out[rid] == []                       # poisoned logits: no token


def test_fault_retier_readmits_from_scratch(model):
    """A faulted cheap-tier request restarts on the exact tier: its cheap
    tokens are discarded, and its output equals a request submitted to the
    exact tier directly."""
    p = _prompts(model.cfg.vocab, [6])[0]
    cbe = ContinuousBatchingEngine(model, TIERS, max_len=32, capacity=2, page_size=4,
                                   fault_retier={"cheap": "exact"})
    _poison(cbe._lanes["cheap"], "step")
    rid = cbe.submit(p, 6, tier="cheap")
    out = cbe.drain()
    req = cbe.finished[rid]
    assert req.status == "ok" and req.retiers == 1 and req.tier == "exact"
    assert len(out[rid]) == 6
    oracle = ContinuousBatchingEngine(model, TIERS, max_len=32, capacity=2, page_size=4)
    r2 = oracle.submit(p, 6, tier="exact")
    assert out[rid] == oracle.drain()[r2]


def test_fault_retier_second_fault_retires(model):
    cbe = ContinuousBatchingEngine(model, TIERS, max_len=32, capacity=2, page_size=4,
                                   fault_retier={"cheap": "exact"})
    _poison(cbe._lanes["cheap"], "step")
    _poison(cbe._lanes["exact"], "step")        # the strong tier fails too
    rid = cbe.submit(_prompts(model.cfg.vocab, [6])[0], 6, tier="cheap")
    cbe.drain()
    req = cbe.finished[rid]
    assert req.status == "fault" and req.retiers == 1


def test_fault_retier_validation(model):
    with pytest.raises(ValueError, match="both"):
        ContinuousBatchingEngine(model, TIERS, max_len=32, capacity=1, page_size=4,
                                 fault_retier={"cheap": "gold"})
    with pytest.raises(ValueError, match="itself"):
        ContinuousBatchingEngine(model, TIERS, max_len=32, capacity=1, page_size=4,
                                 fault_retier={"cheap": "cheap"})


def test_poisoned_params_fault_end_to_end(model):
    """No wrapping: NaN weights make the real prefill emit non-finite logits
    and the finite check on the device quarantines the request."""
    cfg = model.cfg
    bad = lm_params_from_jax(_nan_tree(model), cfg, device="cpu")
    cbe = ContinuousBatchingEngine(bad, NATIVE, max_len=32, capacity=1, page_size=4)
    rid = cbe.submit(_prompts(cfg.vocab, [6])[0], 4)
    out = cbe.drain()
    assert cbe.finished[rid].status == "fault"
    assert out[rid] == []


def _nan_tree(model):
    """The JAX-layout tree of ``model`` with every leaf NaN."""
    from repro_torch.convert import lm_params_to_numpy
    return jax.tree_util.tree_map(lambda a: np.full_like(a, np.nan), lm_params_to_numpy(model))


def test_healthy_neighbours_survive_slot_fault(model):
    """Quarantine is per slot: poison only one slot's ok flag and the other
    resident request keeps decoding to completion."""
    cbe = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=2, page_size=4)
    p1, p2 = _prompts(model.cfg.vocab, [6, 9])
    r1 = cbe.submit(p1, 6)
    r2 = cbe.submit(p2, 6)
    cbe.step()                                  # both admitted
    lane = cbe._lanes["default"]
    slot1 = next(s for s in range(cbe.capacity)
                 if lane.slot_req[s] is not None and lane.slot_req[s].rid == r1)
    orig = lane.step

    def poison_slot1(*a):
        nxt, ok, caches = orig(*a)
        ok = ok.clone()
        ok[slot1] = False
        return nxt, ok, caches
    lane.step = poison_slot1
    out = cbe.drain()
    assert cbe.finished[r1].status == "fault"
    assert cbe.finished[r2].status == "ok" and len(out[r2]) == 6
    solo = ContinuousBatchingEngine(model, NATIVE, max_len=32, capacity=2, page_size=4)
    rs = solo.submit(p2, 6)
    assert out[r2] == solo.drain()[rs]

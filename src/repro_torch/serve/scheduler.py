"""Continuous batching over paged KV caches, with per-request numerics
tiers: the port of ``repro.serve.scheduler``.

``ContinuousBatchingEngine`` generalises ``ServingEngine`` from "one fixed
batch, ring caches, run to completion" to a request stream: requests
arrive with their own prompt length, token budget and numerics tier, are
admitted into fixed slots as capacity frees up, and retire one by one.
The batch changes every tick while the step functions keep their shapes.

Fixed shapes, moving batch
    Each decode tick runs over a fixed-capacity ``(C, 1)`` slot tensor plus
    per-slot control arrays (page table, start position, liveness).
    Admission and eviction change only the host-side control mirror
    (``serve/paged_cache.LaneControl``); dead slots decode garbage into the
    trash page and their rows are discarded.  The control arrays go to the
    card as one pinned buffer without waiting, so a dense tick waits on
    the card once, when ``(next, ok)`` is read back.

Numerics tiers
    ``tiers`` maps a tier name to a policy (flat or a ``PolicyTable``).
    Each tier gets its own *lane*: its own slots, page pools, allocator and
    steps over that tier's policy, so every tier's contractions run
    through its own resolved leaf.  Same-tier requests batch together;
    tiers run one after another in a tick.  Under an ``amsim`` leaf a
    lane's decode tick runs the decode chain's kernels with per-row
    positions, and its prefill the GEMM and attention kernels.

Scheduling (deterministic, greedy)
    Per tick: (1) retire queued requests whose deadline lapsed; (2) FIFO
    admission with head-of-line blocking (no reordering, so admission
    order is reproducible); (3) page faults: allocate the page each live
    slot's next decode write needs, preempting the youngest other resident
    of the lane when the pool is dry (preemption = release pages + requeue
    with prompt' = prompt ++ emitted; greedy argmax decode makes the
    recomputation token-identical); (4) one batched decode step per lane
    with live slots, then per-slot bookkeeping (append the token, advance
    start, release window-stale pages, retire finished or quarantined
    requests); (5) retire resident requests whose deadline lapsed.

Prefill runs per admission at a bucketed (power-of-two) padded length with
the true length as a tensor, so ragged prompts run at most one prefill
shape per bucket.  There is no ``jit``: the lane steps are plain functions
over the lane's model, policy and pools.  ``decode_trace_counts`` counts
the times a lane's decode step is built (once, at its first tick) and
``prefill_trace_counts`` the distinct prefill buckets a lane ran, the
twins of the JAX package's trace counters.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.policy import Numerics
from repro_torch.models.transformer import LM, init_paged_lm_caches, lm_forward
from .paged_cache import TRASH_PAGE, LaneControl, PageAllocator, pages_for

_MIN_BUCKET = 16


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def _merge_control(caches: list, ptab, live, start) -> list:
    """Each layer's pools with the step's control arrays, the paged cache
    dict that ``models/attention._paged_cache_update`` takes."""
    return [dict(c, ptab=ptab, live=live, start=start) for c in caches]


def _strip_control(caches: list) -> list:
    """Only the persistent device state; control is host-authoritative and
    uploaded for every step, never read back."""
    return [{"pool_k": c["pool_k"], "pool_v": c["pool_v"]} for c in caches]


def make_paged_prefill(model: LM, policy: Numerics, window: Optional[int] = None):
    def paged_prefill(tokens, true_len, ptab, caches):
        """tokens (B, P) right-padded, true_len (B,), ptab (B, n_ptab) ->
        (next_token (B, 1) int32, ok (B,) bool, caches).  ``ok`` is the
        non-finite-logit sentinel, computed on the device: False marks a
        request whose next-token distribution is poisoned (argmax would be
        garbage); the scheduler quarantines it instead of emitting.

        Padding is harmless: queries past true_len are never read (the next
        token comes from position true_len - 1), their K/V writes land in
        allocated-but-not-yet-valid positions or the trash page, and causal
        masking keeps real queries from seeing anything at or past their
        own position.
        """
        B = tokens.shape[0]
        dev = tokens.device
        merged = _merge_control(caches, ptab, torch.ones((B,), dtype=torch.bool, device=dev),
                                torch.zeros((B,), dtype=torch.int32, device=dev))
        logits, merged, _ = lm_forward(model, tokens, policy, caches=merged, window=window)
        idx = (true_len.long() - 1)[:, None, None].expand(B, 1, logits.shape[-1])
        last = torch.gather(logits, 1, idx)
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        ok = torch.isfinite(last[:, 0, :]).all(dim=-1)
        return nxt, ok, _strip_control(merged)
    return paged_prefill


def make_paged_serve_step(model: LM, policy: Numerics, window: Optional[int] = None):
    def paged_serve_step(tokens, live, start, ptab, caches):
        """One decode step over every slot of a lane: tokens (C, 1), live
        (C,), start (C,), ptab (C, n_ptab) -> (next (C, 1) int32, ok (C,)
        bool, caches).  ``ok`` False = non-finite logits in that slot
        (fault quarantine).

        Dead slots ride along at fixed shape: their writes go to the trash
        page and the scheduler discards their outputs.
        """
        merged = _merge_control(caches, ptab, live, start)
        logits, merged, _ = lm_forward(model, tokens, policy, caches=merged, window=window)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        ok = torch.isfinite(logits[:, -1, :]).all(dim=-1)
        return nxt, ok, _strip_control(merged)
    return paged_serve_step


@dataclasses.dataclass
class Request:
    """One generation request in the stream.

    ``status`` is ``"ok"`` until the engine retires the request early:
    ``"fault"`` (non-finite logits with no stronger tier to retry on) or
    ``"deadline"`` (tick budget expired).  Early-retired requests keep
    whatever tokens they emitted.  ``expires_at`` is the absolute engine
    tick the deadline lapses at (None = no deadline); ``retiers`` counts
    fault re-admissions onto a stronger tier.
    """
    rid: int
    prompt: list
    max_new_tokens: int
    tier: str
    out: list = dataclasses.field(default_factory=list)
    preemptions: int = 0
    expires_at: Optional[int] = None
    status: str = "ok"
    retiers: int = 0

    @property
    def cur_prompt(self) -> list:
        """Prompt a (re-)admission prefills: the original prompt plus every
        token already emitted (greedy decode is deterministic, so
        recomputing from here reproduces the continuation exactly)."""
        return list(self.prompt) + list(self.out)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens


class _Lane:
    """Per-tier execution lane: slots, page pools and the steps over this
    tier's policy.  ``step`` and ``prefill`` are attributes a caller may
    wrap (the robustness tests poison their ``ok``)."""

    def __init__(self, engine: "ContinuousBatchingEngine", name: str, policy: Numerics,
                 n_pages: int):
        self.name, self.policy = name, policy
        self.alloc = PageAllocator(n_pages)
        self.ctrl = LaneControl(engine.capacity, engine.n_ptab)
        self.slot_req: list[Optional[Request]] = [None] * engine.capacity
        self.slot_pages: list[dict] = [{} for _ in range(engine.capacity)]
        self.slot_seq = [0] * engine.capacity  # admission order, for victim pick
        self.caches = init_paged_lm_caches(engine.model.cfg, n_pages, engine.page_size,
                                           engine.device)
        self.decode_builds = 0
        self.decode_ticks = 0
        self.prefill_buckets: set[int] = set()
        self.pages_high = 0           # most pages held at once
        # Host-clock seconds of each decode tick and of each admission's
        # prefill by bucket, from the upload to the read-back (which waits
        # for the device).
        self.decode_s: list[float] = []
        self.prefill_s: dict[int, list[float]] = {}
        self._model, self._window = engine.model, engine.window
        self._step = None
        self._prefill = make_paged_prefill(engine.model, policy, engine.window)

    def step(self, tokens, live, start, ptab, caches):
        """The lane's decode step, built at its first call."""
        if self._step is None:
            self._step = make_paged_serve_step(self._model, self.policy, self._window)
            self.decode_builds += 1
        return self._step(tokens, live, start, ptab, caches)

    def prefill(self, tokens, true_len, ptab, caches):
        self.prefill_buckets.add(tokens.shape[1])
        return self._prefill(tokens, true_len, ptab, caches)

    def note_pages(self) -> None:
        self.pages_high = max(self.pages_high, self.alloc.capacity - self.alloc.n_free)


class ContinuousBatchingEngine:
    """Greedy continuous-batching server over paged KV caches, on the
    model's device.

    Parameters
    ----------
    model: the LM (``models/transformer.init_lm``); its device is the
        engine's.
    tiers: mapping tier name -> policy, or a single policy (becomes the
        sole tier ``"default"``).
    max_len: per-request position budget; submit rejects any request whose
        prompt + token budget exceeds it (the ``ServingEngine.generate``
        contract).
    capacity: resident slots per tier lane.
    page_size: tokens per KV page.
    n_pages: pool size per lane, *including* the reserved trash page.  The
        default fully reserves ``capacity`` requests at ``max_len`` (no
        preemption unless the caller overcommits on purpose).
    window: sliding attention window (None -> cfg.sliding_window, 0 =
        off).  With a window, pages whose every key has slid out are
        released mid-flight and admission skips pages that would be stale
        on arrival, so long streams hold ~window worth of pages.
    fault_retier: optional tier name -> stronger tier name map.  When a
        request's logits go non-finite it is re-admitted once, from
        scratch, on the mapped tier; without a mapping, or on a second
        fault, it retires with ``status="fault"``.
    """

    def __init__(self, model: LM, tiers, *, max_len: int = 512, capacity: int = 4,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 window: Optional[int] = None, fault_retier: Optional[dict] = None):
        if not isinstance(tiers, dict):
            tiers = {"default": tiers}
        if not tiers:
            raise ValueError("need at least one tier")
        self.model, self.cfg = model, model.cfg
        self.device = model.embed.emb.device
        self.max_len, self.capacity = max_len, capacity
        self.page_size = page_size
        self.n_ptab = -(-max_len // page_size)
        self.n_pages = capacity * self.n_ptab + 1 if n_pages is None else n_pages
        self.window = self.cfg.sliding_window if window is None else window
        self._lanes = {name: _Lane(self, name, pol, self.n_pages)
                       for name, pol in tiers.items()}
        self.fault_retier = dict(fault_retier or {})
        for src, dst in self.fault_retier.items():
            if src not in self._lanes or dst not in self._lanes:
                raise ValueError(f"fault_retier {src!r} -> {dst!r}: both must be tiers in "
                                 f"{sorted(self._lanes)}")
            if src == dst:
                raise ValueError(f"fault_retier maps {src!r} to itself")
        self._queue: deque[Request] = deque()
        self._next_rid = 0
        self._seq = 0
        self.tick = 0
        self.finished: dict[int, Request] = {}

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int, tier: str = "default", *,
               deadline: Optional[int] = None) -> int:
        """Queue one request; returns its id.  Validates up front, so a
        request that could never run (or could deadlock the pool) is
        rejected at submit time, not mid-stream.  ``deadline`` is a tick
        budget: a request still unfinished ``deadline`` engine ticks from
        now retires with ``status="deadline"`` and partial output."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if tier not in self._lanes:
            raise ValueError(f"unknown tier {tier!r}; have {sorted(self._lanes)}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                             f"exceeds max_len ({self.max_len})")
        # The last emitted token is never written back, so a request stores
        # at most len(prompt) + max_new - 1 positions; under a sliding
        # window only ~window of them are resident at once.
        need = pages_for(len(prompt) + max_new_tokens - 1, self.page_size)
        if self.window:
            need = min(need, pages_for(self.window, self.page_size) + 2)
        cap = self._lanes[tier].alloc.capacity
        if need > cap:
            raise ValueError(f"request needs up to {need} pages resident but the {tier!r} lane "
                             f"pool only has {cap}; raise n_pages or page_size")
        if deadline is not None and deadline < 1:
            raise ValueError(f"deadline must be >= 1 tick, got {deadline}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, prompt, max_new_tokens, tier,
                                   expires_at=None if deadline is None else self.tick + deadline))
        return rid

    # ---------------------------------------------------------- scheduling
    def step(self) -> list[Request]:
        """One scheduler tick; returns the requests that finished
        (including early retirements: check ``Request.status``)."""
        finished: list[Request] = []
        self.tick += 1
        self._expire_queued(finished)
        self._admit(finished)
        # Faults AFTER admission: a freshly admitted slot whose prompt exactly
        # fills its pages needs the next page before its first decode write,
        # or the KV lands in the trash page and is lost.
        for lane in self._lanes.values():
            self._resolve_faults(lane)
        for lane in self._lanes.values():
            self._decode(lane, finished)
        for lane in self._lanes.values():
            self._expire_resident(lane, finished)
        for req in finished:
            self.finished[req.rid] = req
        return finished

    def _progress(self):
        """Drain's liveness signal.  Besides queue/resident/token counts it
        tracks retirements and re-tiers: a request admitted, quarantined and
        re-queued on a stronger tier within one tick leaves the first three
        fields unchanged but IS forward progress (re-tiers are capped, so
        this cannot mask a real head-of-line deadlock)."""
        return (len(self._queue),
                sum(int(l.ctrl.live.sum()) for l in self._lanes.values()),
                sum(len(r.out) for l in self._lanes.values() for r in l.slot_req
                    if r is not None),
                len(self.finished),
                sum(r.retiers for r in self._queue))

    def _busy(self) -> bool:
        return bool(self._queue) or any(l.ctrl.live.any() for l in self._lanes.values())

    def drain(self) -> dict:
        """Tick until queue and slots are empty; returns rid -> tokens."""
        while self._busy():
            before = self._progress()
            self.step()
            if before == self._progress() and not any(l.ctrl.live.any()
                                                      for l in self._lanes.values()):
                raise RuntimeError("scheduler made no progress with nothing resident: the "
                                   "head-of-line request cannot be admitted")
        return {rid: list(req.out) for rid, req in self.finished.items()}

    def run(self, stream) -> dict:
        """Drive a timed request stream: ``stream`` is an iterable of
        ``(arrival_tick, prompt, max_new_tokens, tier)``.  Requests are
        submitted when the scheduler tick reaches their arrival; ticks run
        until everything drains.  Returns rid -> emitted tokens, in
        submission order of the (arrival-sorted) stream."""
        pending = sorted(stream, key=lambda r: r[0])
        tick = i = 0
        while i < len(pending) or self._busy():
            while i < len(pending) and pending[i][0] <= tick:
                _, prompt, max_new, tier = pending[i]
                self.submit(prompt, max_new, tier)
                i += 1
            self.step()
            tick += 1
        return {rid: list(req.out) for rid, req in self.finished.items()}

    # ------------------------------------------------------------ internals
    def _upload(self, *arrays) -> list:
        """The host arrays as int32 tensors on the engine's device, in one
        copy: on a card from pinned memory without waiting."""
        flat = np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in arrays])
        buf = torch.from_numpy(flat)
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        out, at = [], 0
        for a in arrays:
            n = int(np.prod(np.shape(a)))
            out.append(buf[at:at + n].reshape(np.shape(a)))
            at += n
        return out

    @staticmethod
    def _readback(nxt, ok):
        """(next tokens, ok flags) as numpy, in one device-to-host copy."""
        both = torch.cat([nxt.reshape(-1), ok.to(torch.int32)]).cpu().numpy()
        n = nxt.numel()
        return both[:n], both[n:].astype(bool)

    def _resolve_faults(self, lane: _Lane) -> None:
        """Ensure every live slot owns the page its next decode write lands
        in, preempting the youngest other resident when the pool is dry."""
        ctrl, ps = lane.ctrl, self.page_size
        for slot in range(self.capacity):
            if not ctrl.live[slot]:
                continue
            idx = int(ctrl.start[slot]) // ps
            while ctrl.ptab[slot, idx] == TRASH_PAGE:
                got = lane.alloc.alloc(1)
                if got is not None:
                    ctrl.ptab[slot, idx] = got[0]
                    lane.slot_pages[slot][idx] = got[0]
                    lane.note_pages()
                    break
                victims = [s for s in range(self.capacity) if s != slot and ctrl.live[s]]
                if not victims:
                    raise RuntimeError(f"lane {lane.name!r}: page pool exhausted by a single "
                                       f"request; submit validation should have rejected it")
                self._preempt(lane, max(victims, key=lambda s: lane.slot_seq[s]))

    def _preempt(self, lane: _Lane, slot: int) -> None:
        """Evict by recompute: drop the slot's pages and requeue it at the
        front with prompt' = prompt ++ emitted."""
        req = lane.slot_req[slot]
        self._release_slot(lane, slot)
        req.preemptions += 1
        self._queue.appendleft(req)

    def _quarantine(self, req: Request, finished: list) -> None:
        """Non-finite logits in ``req``'s slot: the emitted distribution is
        poisoned, so no token is appended.  With a ``fault_retier`` mapping
        and a first fault, restart the request from scratch on the stronger
        tier (its earlier tokens came off the faulty datapath: discard
        them); otherwise retire with status="fault"."""
        dst = self.fault_retier.get(req.tier)
        if dst is not None and req.retiers == 0:
            req.retiers += 1
            req.tier = dst
            req.out = []
            self._queue.appendleft(req)
        else:
            req.status = "fault"
            finished.append(req)

    def _expire_queued(self, finished: list) -> None:
        """Retire queued requests whose deadline lapsed before they ever got
        (or re-got) a slot: they can no longer finish in budget."""
        if not any(r.expires_at is not None for r in self._queue):
            return
        keep: deque[Request] = deque()
        for req in self._queue:
            if req.expires_at is not None and self.tick > req.expires_at:
                req.status = "deadline"
                finished.append(req)
            else:
                keep.append(req)
        self._queue = keep

    def _expire_resident(self, lane: _Lane, finished: list) -> None:
        """Retire live slots whose tick budget is spent (after this tick's
        decode, so a request gets exactly ``deadline`` ticks)."""
        for slot in range(self.capacity):
            if not lane.ctrl.live[slot]:
                continue
            req = lane.slot_req[slot]
            if req.expires_at is not None and self.tick >= req.expires_at:
                req.status = "deadline"
                self._release_slot(lane, slot)
                finished.append(req)

    def _release_slot(self, lane: _Lane, slot: int) -> None:
        lane.alloc.release(lane.slot_pages[slot].values())
        lane.slot_pages[slot] = {}
        lane.slot_req[slot] = None
        lane.ctrl.clear_slot(slot)

    def _admit(self, finished: list) -> None:
        """FIFO admission with head-of-line blocking: the oldest queued
        request either gets a slot and pages in its tier's lane (its
        prefill runs at once) or blocks everything behind it."""
        while self._queue:
            req = self._queue[0]
            lane = self._lanes[req.tier]
            free = lane.ctrl.free_slots()
            if not free:
                break
            cur = req.cur_prompt
            m = len(cur)
            # Under a sliding window, skip pages already fully stale for the
            # prefill's own last query (key positions < m - window are
            # outside every mask it can apply); their writes fall through to
            # the trash page.
            lo = max(0, m - self.window) // self.page_size if self.window else 0
            hi = pages_for(m, self.page_size) - 1
            pages = lane.alloc.alloc(hi - lo + 1)
            if pages is None:
                break
            lane.note_pages()
            self._queue.popleft()
            slot = free[0]
            ctrl = lane.ctrl
            for j, p in zip(range(lo, hi + 1), pages):
                ctrl.ptab[slot, j] = p
                lane.slot_pages[slot][j] = p
            bucket = _bucket(m)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :m] = cur
            t0 = time.perf_counter()
            tokens, true_len, ptab = self._upload(toks, [m], ctrl.ptab[slot:slot + 1])
            nxt, ok, lane.caches = lane.prefill(tokens, true_len, ptab, lane.caches)
            nxt, ok = self._readback(nxt, ok)
            lane.prefill_s.setdefault(bucket, []).append(time.perf_counter() - t0)
            lane.slot_req[slot] = req
            if not ok[0]:
                self._release_slot(lane, slot)
                self._quarantine(req, finished)
                continue
            tok = int(nxt[0])
            req.out.append(tok)
            self._seq += 1
            lane.slot_seq[slot] = self._seq
            if req.done:
                self._release_slot(lane, slot)
                finished.append(req)
            else:
                ctrl.live[slot] = True
                ctrl.start[slot] = m
                ctrl.last_tok[slot] = tok
                self._maybe_release_stale(lane, slot)

    def _decode(self, lane: _Lane, finished: list) -> None:
        ctrl = lane.ctrl
        if not ctrl.live.any():
            return
        t0 = time.perf_counter()
        tokens, live, start, ptab = self._upload(ctrl.last_tok[:, None], ctrl.live, ctrl.start,
                                                 ctrl.ptab)
        nxt, ok, lane.caches = lane.step(tokens, live.bool(), start, ptab, lane.caches)
        nxt, ok = self._readback(nxt, ok)
        lane.decode_ticks += 1
        lane.decode_s.append(time.perf_counter() - t0)
        for slot in range(self.capacity):
            if not ctrl.live[slot]:
                continue
            req = lane.slot_req[slot]
            if not ok[slot]:
                self._release_slot(lane, slot)
                self._quarantine(req, finished)
                continue
            tok = int(nxt[slot])
            req.out.append(tok)
            ctrl.start[slot] += 1
            ctrl.last_tok[slot] = tok
            if req.done:
                self._release_slot(lane, slot)
                finished.append(req)
            else:
                self._maybe_release_stale(lane, slot)

    def _maybe_release_stale(self, lane: _Lane, slot: int) -> None:
        """Release leading pages whose every key has slid out of the window
        for all queries from position start onward (page j is dead once
        (j+1)*page_size - 1 <= start - window)."""
        if not self.window:
            return
        cut = (int(lane.ctrl.start[slot]) - self.window + 1) // self.page_size
        if cut <= 0:
            return
        for j in [j for j in lane.slot_pages[slot] if j < cut]:
            lane.alloc.release([lane.slot_pages[slot].pop(j)])
            lane.ctrl.ptab[slot, j] = TRASH_PAGE

    # ---------------------------------------------------------- telemetry
    @property
    def decode_trace_counts(self) -> dict:
        """Tier name -> times its decode step was built (once, at the lane's
        first decode tick; 0 when it never decoded)."""
        return {n: lane.decode_builds for n, lane in self._lanes.items()}

    @property
    def prefill_trace_counts(self) -> dict:
        """Tier name -> distinct prefill buckets run (at most one per
        power-of-two prompt bucket)."""
        return {n: len(lane.prefill_buckets) for n, lane in self._lanes.items()}

    @property
    def n_free_pages(self) -> dict:
        return {n: lane.alloc.n_free for n, lane in self._lanes.items()}

    @property
    def decode_ticks(self) -> dict:
        """Tier name -> decode steps run."""
        return {n: lane.decode_ticks for n, lane in self._lanes.items()}

    @property
    def pages_high(self) -> dict:
        """Tier name -> the most pages its lane held at once."""
        return {n: lane.pages_high for n, lane in self._lanes.items()}

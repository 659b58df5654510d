"""Overload-safe batched serving engine: bucketed batch prefill, paged KV,
CMR-priced admission control, over the prefill and decode of the ported
families (``models.transformer.PORTED_FAMILIES``).

The engine owns B decode slots.  For the attention-cache families (dense,
moe, vlm) the KV lives in a paged pool (``serve.kv_pages``): each request
owns just the pages its depth needs, taken from a free-list allocator as
decode crosses page boundaries, and a (B, max_pages) page table routes the
fused ``decode_step``.  Prompts are admitted through length-bucketed batch
prefill (``serve.buckets`` / ``prefill_bucket``), right-padding exact by
causality; a prompt beyond the ladder takes the exact-length prefill rung.

The recurrent families (ssm, hybrid) and the encoder-decoder (encdec)
keep the dense-slot rung (``paged=False``; a dense model may take it
too): one (L, B, ...) cache of every slot, an exact-length prefill of each
prompt into a one-slot cache whose every leaf is then copied into the
slot's region, since pad tokens would run through the recurrent state
(encdec: the slot's cross K / V come with it).  That rung has no pages,
no buckets and no cost model: ``submit`` rejects nothing.

The stub frontends' inputs are zeros, as in the reference: ``frames``
(encdec) and ``patch_embeds`` (vlm).  A vlm request's depth counts its
``num_patches`` patch rows (``self.extra``) in front of its tokens: in the
pool's size, the pages admission takes, the slot's position and the
decode stop at ``max_len - 1 + extra``.

One fused ``decode_step`` advances every slot one token per tick with
per-slot positions, so slots at different depths write and mask at their
own rows (an idle slot decodes into its own region, which the next
prefill there overwrites).  Sampling is greedy or temperature (a seeded
``torch.Generator`` on the engine's device).  Detokenization runs on a
worker thread fed by a token queue, off the decode loop.

Overload safety (chaos-tested; see ``runtime.chaos``):

  * ``submit`` prices each deadline-carrying request against the
    measurement-calibrated cost model and raises typed ``Overloaded`` when
    the projected completion misses the deadline;
  * deadline-infeasible queued work is shed oldest-first as estimates
    move, and expired requests (queued or active) free their resources;
  * KV page exhaustion preempts the lowest-priority active request (pages
    freed, request re-queued for re-prefill of prompt + generated tokens;
    greedy decode makes recovery bit-identical); admission never preempts,
    it waits (the ``page_exhaustion`` site forces this path);
  * a prompt beyond the bucket ladder takes the exact-length prefill (the
    ``bucket_miss`` site forces the rung);
  * transient decode faults retry with exponential backoff
    (``transient_decode`` site); non-finite logits (``nan_logits`` site)
    quarantine the slot: its pages (or its dense-slot region) are zeroed
    and the request re-prefills.

The engine runs on the CUDA card unless ``device`` says otherwise, and
raises when no card is present and no device is given; the parameters
must already live on that device.  Every GEMM goes through the ftIMM
kernels there (``core.gemm``), with no fallback.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.device import module_device, resolve_device
from ..core.gemm import plan_mode_stats
from ..models.model import (DenseLM, decode_step, make_cache, prefill,
                            prefill_bucket)
from ..models.transformer import check_family
from ..runtime import chaos as _chaos
from .buckets import CostModel, bucket_for, make_buckets
from .kv_pages import PageAllocator, PagedKV, PagesExhausted, pages_for

PAGED_FAMILIES = ("dense", "moe", "vlm")    # the attention-cache families


class Overloaded(RuntimeError):
    """Typed admission rejection: the engine cannot meet this request's
    deadline at current load, or the request cannot fit the KV pool at
    all.  Raised by ``submit`` before the request consumes anything."""

    def __init__(self, reason: str, *, projected_s: float | None = None,
                 deadline_s: float | None = None):
        msg = reason
        if projected_s is not None and deadline_s is not None:
            msg += (f" (projected {projected_s:.3f}s"
                    f" > deadline {deadline_s:.3f}s)")
        super().__init__(msg)
        self.reason = reason
        self.projected_s = projected_s
        self.deadline_s = deadline_s


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    deadline_s: float | None = None   # wall-clock budget from submit()
    priority: int = 0             # higher survives page pressure longer
    out_tokens: list = dataclasses.field(default_factory=list)
    text: str = ""                # filled by the detokenize worker
    done: bool = False
    timed_out: bool = False
    shed: bool = False            # dropped by load shedding / admission
    submitted_at: float = 0.0


class _Detokenizer:
    """Worker thread turning emitted token ids into ``Request.text`` off
    the decode loop; ``drain()`` joins the queue at the end of a run."""

    def __init__(self, fn):
        self.fn = fn
        self.q: _queue.Queue = _queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            req, tok = item
            try:
                req.text += self.fn(tok)
            finally:
                self.q.task_done()

    def put(self, req: Request, tok: int) -> None:
        self.q.put((req, tok))

    def drain(self) -> None:
        self.q.join()

    def close(self) -> None:
        self.q.put(None)
        self._thread.join(timeout=5)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: DenseLM, *,
                 batch_slots: int = 4, max_len: int = 512, seed: int = 0,
                 page_size: int = 16, num_pages: int | None = None,
                 buckets: tuple[int, ...] | None = None, detokenize=None,
                 device: str | torch.device | None = None,
                 paged: bool | None = None, decode_retries: int = 2,
                 retry_backoff_s: float = 0.02):
        """``paged``: the paged KV pool and bucketed prefill (default for
        dense, moe and vlm), or the dense-slot rung (False; the only one of
        ssm, hybrid and encdec).  A decode step that raises
        ``TransientFault`` is retried up to ``decode_retries`` times, after
        ``retry_backoff_s`` seconds doubled at each attempt."""
        check_family(cfg)
        self.device = resolve_device(device)
        if module_device(params) != self.device:
            raise ValueError(f"parameters live on {module_device(params)}, "
                             f"the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.b = batch_slots
        self.max_len = max_len
        self.extra = cfg.num_patches or 0
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.pos = np.zeros(batch_slots, np.int32)       # filled length/slot
        self.active: list[Request | None] = [None] * batch_slots
        self.queue: list[Request] = []
        self.decode_retries = decode_retries
        self.retry_backoff_s = retry_backoff_s
        self._detok = _Detokenizer(detokenize) if detokenize else None
        self.faults = {"transient_retries": 0, "deadline_expired": 0,
                       "nonfinite_quarantined": 0, "admission_rejected": 0,
                       "shed": 0, "preemptions": 0, "bucket_misses": 0}
        self.paged = cfg.family in PAGED_FAMILIES if paged is None else paged
        if self.paged and cfg.family not in PAGED_FAMILIES:
            raise ValueError(f"paged KV unsupported for {cfg.family}")
        if self.paged:
            self.page_size = page_size
            depth_cap = max_len + self.extra
            self.num_pages = (num_pages if num_pages is not None
                              else batch_slots * pages_for(depth_cap,
                                                           page_size))
            self.alloc = PageAllocator(self.num_pages, first=1)
            # The pool holds the reserved null page 0 in front of the
            # allocatable ids [1, num_pages].
            self.kv = PagedKV.build(cfg, slots=batch_slots, max_len=depth_cap,
                                    num_pages=self.num_pages + 1,
                                    page_size=page_size, device=self.device)
            self.cache = None
            self.buckets = tuple(buckets) if buckets else make_buckets(max_len)
            # Pricing every bucket plans every serving GEMM signature up
            # front.
            self.cost: CostModel | None = CostModel(cfg, self.buckets,
                                                    batch_slots)
        else:
            self.cache = make_cache(cfg, batch_slots, max_len,
                                    device=self.device)
            self.alloc = self.kv = self.cost = None
            self.buckets = ()
        # The first call of each prefill shape (and the first decode) pays
        # one-time costs (kernel library load, allocator growth); feeding
        # it to the cost EWMAs would overprice steady state.
        self._timed_buckets: set = set()
        self._timed_step = False
        # Wall seconds of every prefill, as (bucket, s) with bucket None for
        # an exact-length prefill (either rung), and of every fused decode
        # step.
        self.walls: dict[str, list] = {"prefill": [], "decode": []}

    # -------------------------- request plumbing ------------------------

    def _req_tokens(self, req: Request) -> np.ndarray:
        """What a (re-)prefill must run: prompt + everything generated so
        far (preemption / quarantine recovery re-enters here)."""
        if req.out_tokens:
            return np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(req.out_tokens, np.int32)])
        return np.asarray(req.prompt, np.int32)

    def submit(self, req: Request) -> None:
        """Admit ``req`` to the queue, or raise typed ``Overloaded``: only
        when the request carries a deadline and the cost model has measured
        wall times to price against, or when it could never fit the pool
        (the dense-slot rung has neither: it rejects nothing)."""
        req.submitted_at = time.monotonic()
        if self.paged:
            # Depth is also capped by max_len (decode stops there).
            worst = pages_for(min(len(req.prompt) + req.max_new_tokens,
                                  self.max_len) + self.extra, self.page_size)
            if worst > self.alloc.total:
                self.faults["admission_rejected"] += 1
                raise Overloaded(f"request needs {worst} KV pages, pool "
                                 f"holds {self.alloc.total}")
        if req.deadline_s is not None:
            est = self._projected_completion_s(req)
            if est is not None and est > req.deadline_s:
                self.faults["admission_rejected"] += 1
                raise Overloaded("projected completion misses deadline",
                                 projected_s=est, deadline_s=req.deadline_s)
        self.queue.append(req)

    def _projected_completion_s(self, req: Request) -> float | None:
        """Estimated seconds until ``req`` would finish if admitted now:
        amortized prefill share + fused-decode share of the backlog ahead
        of it, plus its own service.  None while uncalibrated or
        unpriced (the dense-slot rung)."""
        if self.cost is None or not self.cost.calibrated():
            return None
        step = self.cost.step_s()
        ahead = sum(max(r.max_new_tokens - len(r.out_tokens), 0)
                    for r in self.active if r is not None)
        ahead += sum(max(r.max_new_tokens - len(r.out_tokens), 0)
                     for r in self.queue)
        pre_backlog = 0.0
        for r in self.queue:
            pre = self.cost.prefill_s(
                bucket_for(len(self._req_tokens(r)), self.buckets))
            pre_backlog += (pre or 0.0) / self.b
        own_pre = self.cost.prefill_s(
            bucket_for(len(self._req_tokens(req)), self.buckets)) or 0.0
        return (pre_backlog + (ahead / self.b) * step + own_pre
                + req.max_new_tokens * step)

    def _frontend_batch(self, toks: np.ndarray) -> dict:
        """The model's batch for (B, S) prompt tokens: the tokens and the
        stub frontends' zero inputs, on the engine's device."""
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.long).to(
            self.device)}
        cfg, bsz = self.cfg, toks.shape[0]
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (bsz, cfg.encoder_seq, cfg.d_model), device=self.device)
        if cfg.num_patches:
            batch["patch_embeds"] = torch.zeros(
                (bsz, cfg.num_patches, cfg.d_model), device=self.device)
        return batch

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        """One token from a (1, V) logits row."""
        if req.temperature <= 0:
            return int(logits.argmax(-1)[0])
        probs = torch.softmax(logits.float() / req.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen)[0, 0])

    def _emit(self, req: Request, tok: int) -> None:
        req.out_tokens.append(tok)
        if self._detok is not None:
            self._detok.put(req, tok)

    # ------------------------------ paging -------------------------------

    def _alloc_pages(self, req: Request, n: int, *,
                     active_slot: int | None = None) -> list[int] | None:
        """Acquire ``n`` pages for ``req``, or None if it must wait.

        Admission-time calls (``active_slot`` None) never preempt: an
        incoming request waits rather than thrash live decode.  Decode-growth
        calls preempt the lowest-priority active victim (ties: youngest
        submitted) with ``priority <= req.priority``; when the best victim
        is ``req`` itself, it yields its own slot.  The ``page_exhaustion``
        chaos site forces the exhaustion branch even with free pages."""
        forced = _chaos.should_fire("page_exhaustion") is not None
        while True:
            if forced:
                forced = False
            else:
                try:
                    return self.alloc.alloc(n, id(req))
                except PagesExhausted:
                    pass
            if active_slot is None:
                return None
            victim_slot = self._pick_victim(req)
            if victim_slot is None:
                return None
            self._preempt_slot(victim_slot)
            if victim_slot == active_slot:
                return None           # req preempted itself (yielded)

    def _pick_victim(self, req: Request) -> int | None:
        best = None
        for i, r in enumerate(self.active):
            if r is None or r.priority > req.priority:
                continue
            rank = (r.priority, -r.submitted_at, 1 if r is req else 0)
            if best is None or rank < best[0]:
                best = (rank, i)
        return None if best is None else best[1]

    def _preempt_slot(self, slot: int) -> None:
        """Free a victim's pages and send it back to the queue head for
        re-prefill.  Its pages hold finite values, so no zeroing: stale rows
        are position-masked and weigh exactly 0 in the next softmax."""
        r = self.active[slot]
        self.alloc.free_owner(id(r))
        self.kv.clear_slot(slot)
        self.pos[slot] = 0
        self.active[slot] = None
        self.queue.insert(0, r)
        self.faults["preemptions"] += 1

    def _release_slot(self, slot: int, req: Request) -> None:
        if self.paged:
            self.alloc.free_owner(id(req))
            self.kv.clear_slot(slot)
        self.active[slot] = None
        self.pos[slot] = 0

    def _ensure_pages(self) -> None:
        """Grow each active slot's page span to cover the row this tick's
        decode writes; exhaustion preempts (see ``_alloc_pages``)."""
        for i in range(self.b):
            r = self.active[i]
            if r is None:
                continue
            need = pages_for(int(self.pos[i]) + 1, self.page_size)
            have = len(self.alloc.owned(id(r)))
            if need <= have:
                continue
            pages = self._alloc_pages(r, need - have, active_slot=i)
            if pages is None:
                if self.active[i] is r:     # couldn't grow, didn't yield:
                    self._preempt_slot(i)   # requeue rather than wedge
                continue
            self.kv.extend_slot(i, pages, have)

    # --------------------------- admission -------------------------------

    def _admit(self) -> None:
        if not self.paged:
            for slot in range(self.b):
                if self.active[slot] is None and self.queue:
                    req = self.queue.pop(0)
                    self._prefill_one(slot, req, self._req_tokens(req))
            return
        while self.queue:
            free = [i for i in range(self.b) if self.active[i] is None]
            if not free:
                return
            head_toks = self._req_tokens(self.queue[0])
            bkt = bucket_for(len(head_toks), self.buckets)
            if _chaos.should_fire("bucket_miss") is not None:
                bkt = None
            if bkt is None:
                self.faults["bucket_misses"] += 1
                req = self.queue.pop(0)
                if not self._admit_exact(free[0], req, head_toks):
                    return
                continue
            batch: list[tuple[Request, np.ndarray]] = []
            while self.queue and len(batch) < len(free):
                toks = self._req_tokens(self.queue[0])
                if bucket_for(len(toks), self.buckets) != bkt:
                    break
                batch.append((self.queue.pop(0), toks))
            if not self._admit_bucket(free, batch, bkt):
                return

    def _prefill_exact(self, req: Request, toks: np.ndarray,
                       rows: int) -> tuple[int, dict, float]:
        """Exact-length prefill of ``toks`` into a one-slot cache of
        ``rows`` rows (and the patch rows) and one sampled token; the wall
        is recorded.  -> (token, cache, wall seconds)."""
        one_cache = make_cache(self.cfg, 1, rows, device=self.device)
        t0 = time.monotonic()
        logits, one_cache = prefill(self.params, self.cfg,
                                    self._frontend_batch(toks[None, :]),
                                    one_cache)
        tok = self._sample(logits, req)                 # syncs
        wall = time.monotonic() - t0
        self.walls["prefill"].append((None, wall))
        return tok, one_cache, wall

    def _admit_exact(self, slot: int, req: Request,
                     toks: np.ndarray) -> bool:
        """Bucket-miss rung: exact-length prefill, then page-insert.
        False = pool pressure, stop admitting this tick."""
        depth = len(toks) + self.extra
        pages = self._alloc_pages(req, pages_for(depth + 1, self.page_size))
        if pages is None:
            self.queue.insert(0, req)
            return False
        tok, one_cache, wall = self._prefill_exact(req, toks, len(toks))
        key = ("exact", depth)
        if key in self._timed_buckets:
            self.cost.observe_prefill(self.buckets[-1], wall)
        self._timed_buckets.add(key)
        self.kv.insert(slot, pages, one_cache["k"][:, 0, :depth],
                       one_cache["v"][:, 0, :depth])
        self._emit(req, tok)
        self._occupy(slot, req, depth)
        return True

    def _prefill_one(self, slot: int, req: Request,
                     toks: np.ndarray) -> None:
        """Dense-slot rung: exact-length prefill of ``toks``, then every
        leaf's slot region copied in place -- all of it, so nothing an
        earlier occupant (or an idle slot's decode) left there survives."""
        tok, one_cache, _ = self._prefill_exact(req, toks, self.max_len)
        for name, leaf in self.cache.items():
            leaf[:, slot].copy_(one_cache[name][:, 0])
        self._emit(req, tok)
        self._occupy(slot, req, len(toks) + self.extra)

    def _admit_bucket(self, free: list[int],
                      batch: list[tuple[Request, np.ndarray]],
                      bkt: int) -> bool:
        """One bucketed batch prefill: every admitted request's padded
        prompt runs through one stack pass, each row's KV page-inserts into
        its slot.  Pages are allocated first (cheap, host-side) so an
        exhausted pool skips the compute; blocked requests go back to the
        queue head.  False = stop admitting."""
        rows: list[tuple[int, Request, np.ndarray, list[int]]] = []
        blocked = False
        for (req, toks) in batch:
            pages = self._alloc_pages(
                req, pages_for(len(toks) + self.extra + 1, self.page_size))
            if pages is None:
                self.queue.insert(0, req)
                blocked = True
                break
            rows.append((free[len(rows)], req, toks, pages))
        if not rows:
            return not blocked
        toks_pad = np.zeros((self.b, bkt), np.int32)
        lens = np.ones(self.b, np.int32)    # pad rows: one token-0 row
        for j, (_, _, toks, _) in enumerate(rows):
            toks_pad[j, :len(toks)] = toks
            lens[j] = len(toks)
        cache = make_cache(self.cfg, self.b, bkt, device=self.device)
        t0 = time.monotonic()
        logits, cache = prefill_bucket(self.params, self.cfg,
                                       self._frontend_batch(toks_pad), cache,
                                       torch.as_tensor(lens))
        _sync(self.device)                   # the wall we observe
        wall = time.monotonic() - t0
        self.walls["prefill"].append((bkt, wall))
        if bkt in self._timed_buckets:
            self.cost.observe_prefill(bkt, wall)
        self._timed_buckets.add(bkt)
        for j, (slot, req, toks, pages) in enumerate(rows):
            depth = len(toks) + self.extra
            self.kv.insert(slot, pages, cache["k"][:, j, :depth],
                           cache["v"][:, j, :depth])
            self._emit(req, self._sample(logits[j:j + 1], req))
            self._occupy(slot, req, depth)
        return not blocked

    def _occupy(self, slot: int, req: Request, depth: int) -> None:
        """Seat a freshly prefilled request, or finish it at once when the
        prefill's token was its last (a request re-prefilled after
        preemption may have had one token left)."""
        if len(req.out_tokens) >= req.max_new_tokens:
            req.done = True
            self._release_slot(slot, req)
            return
        self.pos[slot] = depth
        self.active[slot] = req

    # --------------------------- containment -----------------------------

    def _evict_slot(self, slot: int) -> None:
        """Quarantine a slot whose occupant produced non-finite values:
        free and zero its pages (the next occupant's p @ V contracts every
        row, masked rows at weight 0, and 0 * NaN = NaN); on the dense-slot
        rung zero the slot's region of every leaf."""
        if not self.paged:
            for leaf in self.cache.values():
                leaf[:, slot].zero_()
            return
        r = self.active[slot]
        pages = self.alloc.free_owner(id(r))
        self.kv.zero_pages(pages)
        self.kv.clear_slot(slot)

    def _requarantine_prefill(self, slot: int, req: Request) -> None:
        """Re-prefill prompt + generated-so-far after quarantine, through
        whichever rung fits."""
        toks = self._req_tokens(req)
        self.active[slot] = None
        self.pos[slot] = 0
        if not self.paged:
            self._prefill_one(slot, req, toks)
            return
        bkt = bucket_for(len(toks), self.buckets)
        if bkt is None:
            self._admit_exact(slot, req, toks)
        else:
            self._admit_bucket([slot], [(req, toks)], bkt)

    def _expire_deadlines(self) -> None:
        now = time.monotonic()
        for slot, r in enumerate(self.active):
            if (r is not None and r.deadline_s is not None
                    and now - r.submitted_at > r.deadline_s):
                r.done = True
                r.timed_out = True
                self.faults["deadline_expired"] += 1
                self._release_slot(slot, r)
        kept = []
        for r in self.queue:
            if (r.deadline_s is not None
                    and now - r.submitted_at > r.deadline_s):
                r.done = True
                r.timed_out = True
                self.faults["deadline_expired"] += 1
            else:
                kept.append(r)
        self.queue = kept
        self._shed_infeasible(now)

    def _shed_infeasible(self, now: float) -> None:
        """Load shedding: drop queued requests whose deadline the current
        estimates say cannot be met, oldest first.  Nothing is shed until
        the cost model has measured wall times."""
        if self.cost is None or not self.cost.calibrated():
            return
        step = self.cost.step_s()
        ahead = sum(max(r.max_new_tokens - len(r.out_tokens), 0)
                    for r in self.active if r is not None)
        kept = []
        for r in self.queue:
            rem = max(r.max_new_tokens - len(r.out_tokens), 0)
            if r.deadline_s is None:
                kept.append(r)
                ahead += rem
                continue
            pre = self.cost.prefill_s(
                bucket_for(len(self._req_tokens(r)), self.buckets)) or 0.0
            est = ((now - r.submitted_at) + pre
                   + (ahead / self.b) * step + rem * step)
            if est > r.deadline_s:
                r.done = True
                r.timed_out = True
                r.shed = True
                self.faults["shed"] += 1
            else:
                kept.append(r)
                ahead += rem
        self.queue = kept

    def _decode_with_retry(self, last: np.ndarray):
        """Run one fused decode, retrying transient faults with exponential
        backoff (bounded; the last attempt propagates)."""
        cache, table = ((self.kv.cache(), self.kv.device_table())
                        if self.paged else (self.cache, None))
        for attempt in range(self.decode_retries + 1):
            try:
                _chaos.fire("transient_decode")
                return decode_step(
                    self.params, self.cfg,
                    torch.as_tensor(last, dtype=torch.long).to(self.device),
                    cache, torch.as_tensor(self.pos, dtype=torch.long),
                    page_table=table)
            except _chaos.TransientFault:
                self.faults["transient_retries"] += 1
                if attempt == self.decode_retries:
                    raise
                time.sleep(self.retry_backoff_s * (2 ** attempt))

    def health(self) -> dict:
        """Operational snapshot: slot occupancy, fault counters, the
        dispatch ladder's degraded servings, and when paged the page-pool
        pressure and admission pricing."""
        degraded = plan_mode_stats().get("degraded", {})
        out = {
            "active_slots": sum(r is not None for r in self.active),
            "queue_depth": len(self.queue),
            "slot_pos": [int(p) for p in self.pos],
            "faults": dict(self.faults),
            "degraded_servings": dict(degraded),
            "degraded_mode": bool(degraded) or any(self.faults.values()),
        }
        if self.paged:
            out["pages"] = {"total": self.alloc.total,
                            "free": self.alloc.available,
                            "page_size": self.page_size,
                            "live_owners": self.alloc.live_owners}
            out["buckets"] = list(self.buckets)
            out["cost"] = self.cost.snapshot()
        if self._detok is not None:
            out["detok_backlog"] = self._detok.q.qsize()
        return out

    # ------------------------------ stepping -----------------------------

    def step(self) -> int:
        """One decode tick across all active slots; returns #active."""
        self._expire_deadlines()
        self._admit()
        if self.paged:
            self._ensure_pages()
        if not any(r is not None for r in self.active):
            return 0
        last = np.zeros((self.b, 1), np.int32)
        for i, r in enumerate(self.active):
            if r is not None and r.out_tokens:
                last[i, 0] = r.out_tokens[-1]
        # One fused decode over all slots with per-slot positions: each row
        # writes its own cache row and masks under its own horizon.
        t0 = time.monotonic()
        logits, _ = self._decode_with_retry(last)
        logits = _chaos.poison_logits(logits)
        finite = torch.isfinite(logits).all(dim=-1).tolist()   # syncs
        wall = time.monotonic() - t0
        self.walls["decode"].append(wall)
        if self.cost is not None and self._timed_step:
            self.cost.observe_step(wall)
        self._timed_step = True
        n_active = 0
        for i, r in enumerate(self.active):
            if r is None:
                continue
            if not finite[i]:
                # Quarantine: drop the slot's (possibly poisoned) cache and
                # re-prefill prompt + tokens so far.
                self.faults["nonfinite_quarantined"] += 1
                self._evict_slot(i)
                self._requarantine_prefill(i, r)
                r = self.active[i]
                if r is None:       # re-prefill blocked on page pressure
                    continue
            else:
                self._emit(r, self._sample(logits[i:i + 1], r))
                self.pos[i] += 1
            if (len(r.out_tokens) >= r.max_new_tokens
                    or self.pos[i] >= self.max_len - 1 + self.extra):
                r.done = True
                self._release_slot(i, r)
            else:
                n_active += 1
        return n_active

    def drain_detok(self) -> None:
        """Block until every emitted token has been detokenized."""
        if self._detok is not None:
            self._detok.drain()

    def close(self) -> None:
        if self._detok is not None:
            self._detok.close()
            self._detok = None

    def run(self, requests: list[Request]) -> list[Request]:
        for r in requests:
            self.submit(r)
        while self.queue or any(r is not None for r in self.active):
            self.step()
        self.drain_detok()
        return requests

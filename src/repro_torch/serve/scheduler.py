"""Continuous-batching request scheduler over the paged KV cache (the port
of ``repro.serve.scheduler`` with whole-prompt prefill).

* the decode batch is ``n_slots`` persistent slots stepped together;
  positions and block tables are data, never shapes;
* each step first admits waiting requests into free slots: a FIFO run of
  requests with one prompt length joins as a group, with one batched
  prefill written into freshly allocated pages;
* sequences grow a page at a time (`PagePool.alloc`) as their position
  crosses a page boundary, and are evicted on EOS or ``max_new``,
  returning their pages at once;
* when the pool cannot grow a sequence, the youngest active request is
  preempted (pages freed, re-queued at the front with its generated
  prefix as the new prompt: recompute, no cache swap);
* inactive slots are not masked: their block tables point at the
  scratch page and the host ignores their samples
  (`repro_torch.models.cache.SCRATCH_PAGE`);
* ``decode_burst > 1`` runs that many decode steps per dispatch with
  every token left on the device, and one device-to-host copy of the
  burst's tokens at its end.  Admissions and evictions land on burst
  boundaries; the burst never runs past the earliest ``max_new`` finish,
  and a lane that hits EOS idles at most ``burst - 1`` steps.  Each
  slot's tokens do not depend on the burst length.

Under greedy sampling each slot's tokens are bitwise the dense layout's
at the same batch width and linearized cache length.

A model with no paged kind (falcon-mamba: its state is O(1) and
slot-indexed) is served by the same loop: the joining group's state is
written into its slot rows, no page is ever allocated, ``_grow`` and the
``max_len`` check of `submit` are skipped, and the pool stays untouched.

Not ported yet: chunked prefill and the prefix cache (``prefill_chunk``,
``prefix_cache``; ROADMAP A11), and requests that carry encoder or
vision inputs.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.models.cache import SCRATCH_PAGE, PagedLayout
from repro_torch.serve.oneshot import SAMPLERS, resolve_sampler
from repro_torch.serve.pool import PagePool


@dataclasses.dataclass
class Request:
    """One generation request.  ``prompt`` is token ids; the generated ids
    (the prefill's sample included, as `OneShotGenerator` returns them)
    accumulate in ``out``."""

    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    # lifecycle times and per-token completion times (perf_counter s)
    t_submit: Optional[float] = None
    t_join: Optional[float] = None
    t_done: Optional[float] = None
    token_walls: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0

    @property
    def resume_tokens(self) -> List[int]:
        """Prompt for (re-)admission: the prompt plus whatever was
        generated before a preemption (recompute-style resume)."""
        return list(self.prompt) + list(self.out)


class Scheduler:
    """Drives a `PagedLayout` decode step over a request stream, on the
    device the params live on."""

    def __init__(self, model, params, *, slots: int = 8, pages: int = 64,
                 page_size: int = 16, max_len: Optional[int] = None,
                 sampler: Optional[str] = None, temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 use_kernel: Optional[bool] = None, decode_burst: int = 1,
                 prefill_chunk: int = 0, prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None):
        if prefill_chunk > 0 or prefix_cache:
            raise NotImplementedError(
                "chunked prefill and the prefix cache are not ported "
                "(ROADMAP A11): use whole-prompt prefill")
        if model.cfg.encoder is not None or model.cfg.vlm is not None:
            raise NotImplementedError(
                "continuous batching serves text-only requests; "
                "encoder-decoder / VLM archs need per-request encoder "
                "inputs")
        self.model = model
        self.params = params
        self.device = T.leaves(params)[0].device
        self.sampler = resolve_sampler(sampler, temperature)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.decode_burst = max(int(decode_burst), 1)
        max_len = int(max_len) if max_len is not None \
            else (pages - 1) * page_size
        max_pages = -(-max_len // page_size)
        if max_pages > pages - 1:
            raise ValueError(
                f"max_len {max_len} needs {max_pages} pages but the pool "
                f"has {pages - 1} usable — a full-length request could "
                f"never be admitted")
        self.layout = PagedLayout(model, n_slots=slots, num_pages=pages,
                                  page_size=page_size, max_pages=max_pages,
                                  use_kernel=use_kernel, kv_dtype=kv_dtype)
        self.pool = PagePool(pages, page_size, reserved=1,
                             bytes_per_page=self.layout.page_bytes())
        self.cache = self.layout.init_cache(device=self.device)
        self.slots: List[Optional[Request]] = [None] * slots
        self.waiting: Deque[Request] = deque()
        self.block_tables = np.full((slots, max_pages), SCRATCH_PAGE,
                                    np.int64)
        self.pos = np.zeros((slots,), np.int64)
        self.next_tok = np.zeros((slots,), np.int64)
        self._slot_pages: List[List[int]] = [[] for _ in range(slots)]
        self._join_order: List[int] = []      # active slots, oldest first
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.finished: List[Request] = []
        self.stats: Dict[str, Any] = {
            "decode_steps": 0, "prefills": 0, "preemptions": 0,
            "tokens": 0, "step_walls": [], "occupancy": [],
        }

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        need = len(req.prompt) + req.max_new + 1
        if self.layout.uses_pages and need > self.layout.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new+1 = {need} exceeds "
                f"max_len {self.layout.max_len} (block-table width)")
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.waiting.append(req)

    # -- device work --------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def decode(self, tok0: torch.Tensor, pos0: torch.Tensor,
               bt: torch.Tensor, burst: int) -> torch.Tensor:
        """``burst`` decode steps for every slot from ``tok0`` (n_slots,)
        at positions ``pos0`` (n_slots,) through block tables ``bt``
        (n_slots, max_pages), all on the device.  Returns the sampled
        tokens (burst, n_slots) on the device: nothing inside waits on the
        host."""
        sample = SAMPLERS[self.sampler]
        tok, pos, toks = tok0, pos0, []
        for _ in range(burst):
            logits, self.cache = self.layout.decode_step(
                self.params, self.cache, tok[:, None], pos, bt)
            tok = sample(logits, self._gen, self.temperature)
            toks.append(tok)
            pos = pos + 1
        return torch.stack(toks)

    # -- slot lifecycle -----------------------------------------------------

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        req.t_done = time.perf_counter()
        self.finished.append(req)
        self._release(slot)

    def _release(self, slot: int) -> None:
        if self._slot_pages[slot]:
            self.pool.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.slots[slot] = None
        self.block_tables[slot, :] = SCRATCH_PAGE
        self.pos[slot] = 0
        self.next_tok[slot] = 0
        self._join_order.remove(slot)

    def _preempt_youngest(self) -> bool:
        """Free the most recently joined request (recompute-resume later).
        Returns False when nothing is active."""
        if not self._join_order:
            return False
        slot = self._join_order[-1]
        req = self.slots[slot]
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self._release(slot)
        self.waiting.appendleft(req)
        return True

    def _admit(self) -> None:
        """Admit waiting requests into free slots.  A FIFO run sharing one
        prompt length joins as a group: one batched prefill dispatch (and
        bitwise the dense fixed-batch prefill when a whole batch joins
        together)."""
        while self.waiting and None in self.slots:
            p_len = len(self.waiting[0].resume_tokens)
            n_pg = self.layout.pages_for(p_len)
            group = []          # [(req, slot, pages)]
            starved = False
            while (self.waiting and None in self.slots
                   and len(self.waiting[0].resume_tokens) == p_len):
                pages = self.pool.alloc(n_pg)
                if pages is None:
                    starved = True
                    break
                req = self.waiting.popleft()
                slot = self.slots.index(None)
                self.slots[slot] = req   # reserve the slot for the group
                group.append((req, slot, pages))
            if not group:
                break  # no memory even for the first request
            logits, self.cache = self.layout.prefill_into(
                self.params, self.cache,
                {"tokens": self._tensor([r.resume_tokens
                                         for r, _, _ in group])},
                self._tensor([p for _, _, p in group]).reshape(
                    len(group), n_pg),
                self._tensor([s for _, s, _ in group]))
            toks = SAMPLERS[self.sampler](logits, self._gen,
                                          self.temperature).tolist()
            now = time.perf_counter()
            self.stats["prefills"] += 1
            for (req, slot, pages), tok in zip(group, toks):
                self._slot_pages[slot] = pages
                self._join_order.append(slot)
                self.block_tables[slot, :] = SCRATCH_PAGE
                self.block_tables[slot, :n_pg] = pages
                self.pos[slot] = p_len
                self.next_tok[slot] = tok
                if req.t_join is None:
                    req.t_join = now
                req.out.append(tok)
                req.token_walls.append(now)
                self.stats["tokens"] += 1
                if self._is_finished(req, tok):
                    self._finish(slot)
            if starved:
                break

    def _is_finished(self, req: Request, tok: int) -> bool:
        return len(req.out) >= req.max_new or \
            (self.eos_id is not None and tok == self.eos_id)

    def _grow(self, burst: int) -> None:
        """Make sure every active slot has pages for the whole coming
        burst's write positions; preempt the youngest request when the
        pool is dry.  Nothing to do when no kind is paged."""
        if not self.layout.uses_pages:
            return
        for slot in list(self._join_order):
            if self.slots[slot] is None:
                continue
            last_write = int(self.pos[slot]) + burst - 1
            need = min(last_write, self.layout.max_len - 1) \
                // self.layout.page_size
            while need >= len(self._slot_pages[slot]):
                got = self.pool.alloc(1)
                if got is None:
                    victim = self._join_order[-1]
                    self._preempt_youngest()
                    if victim == slot:
                        break   # could not shrink below itself
                    continue
                idx = len(self._slot_pages[slot])
                self._slot_pages[slot].append(got[0])
                self.block_tables[slot, idx] = got[0]

    # -- the step -----------------------------------------------------------

    def _used_tokens(self) -> int:
        """Live cache rows: each active slot's positions so far, capped by
        the pages it holds (uncapped when no kind is paged)."""
        ps = self.layout.page_size
        return sum(min(int(self.pos[s]) + 1, len(self._slot_pages[s]) * ps)
                   if self.layout.uses_pages else int(self.pos[s]) + 1
                   for s in range(len(self.slots))
                   if self.slots[s] is not None)

    def step(self) -> bool:
        """Admit, grow, decode one burst (``decode_burst`` tokens) for
        every active slot.  Returns False when there is nothing to do."""
        self._admit()
        active = [s for s in range(len(self.slots))
                  if self.slots[s] is not None]
        if not active:
            return False
        # adaptive burst: never run past the earliest ``max_new`` finish
        # (the freed slot re-admits at once instead of idling out the
        # burst); EOS finishes cannot be predicted and idle at most
        # ``burst - 1`` steps
        rem = min(self.slots[s].max_new - len(self.slots[s].out)
                  for s in active)
        burst = max(1, min(self.decode_burst, rem))
        self._grow(burst)
        active = [s for s in range(len(self.slots))
                  if self.slots[s] is not None]
        if not active:
            return True  # everything got preempted while growing
        t0 = time.perf_counter()
        toks = self.decode(self._tensor(self.next_tok),
                                 self._tensor(self.pos),
                                 self._tensor(self.block_tables), burst)
        toks = toks.cpu().numpy()        # (burst, n_slots): one D2H copy
        now = time.perf_counter()
        self.stats["decode_steps"] += burst
        self.stats["step_walls"].append(now - t0)
        used = self._used_tokens()
        self.stats["occupancy"].append(
            self.pool.stats(used_tokens=used) if self.layout.uses_pages
            else {"used_tokens": used})
        for slot in active:
            req = self.slots[slot]
            for t in range(burst):
                tok = int(toks[t, slot])
                req.out.append(tok)
                # per-token completion, interpolated across the burst
                req.token_walls.append(t0 + (now - t0) * (t + 1) / burst)
                self.stats["tokens"] += 1
                self.pos[slot] += 1
                self.next_tok[slot] = tok
                if self._is_finished(req, tok):
                    self._finish(slot)
                    break
        return True

    # -- drain loop ---------------------------------------------------------

    def run(self, requests: Optional[List[Request]] = None,
            arrivals: Optional[List[float]] = None) -> List[Request]:
        """Submit ``requests`` (optionally at wall-clock ``arrivals``
        offsets in seconds: the Poisson load mode) and step until
        drained."""
        pending = list(requests or [])
        offs = list(arrivals) if arrivals is not None \
            else [0.0] * len(pending)
        if len(offs) != len(pending):
            raise ValueError("one arrival offset per request")
        t0 = time.perf_counter()
        while pending or self.waiting or any(s is not None
                                             for s in self.slots):
            now = time.perf_counter() - t0
            while pending and offs[0] <= now:
                self.submit(pending.pop(0))
                offs.pop(0)
            if not self.step() and pending:
                # idle but arrivals outstanding: wait for the next one
                time.sleep(max(offs[0] - (time.perf_counter() - t0), 0.0))
        return self.finished

    # -- metrics ------------------------------------------------------------

    def latency_summary(self) -> Dict[str, float]:
        """Per-token decode latency and TTFT percentiles, mean occupancy
        and the pool's capacity facts."""
        gaps = []
        ttfts = []
        for req in self.finished:
            # inter-token gaps of the decode phase (the prefill token's
            # latency is time-to-first-token, reported separately)
            ts = req.token_walls
            gaps.extend(b - a for a, b in zip(ts, ts[1:]))
            if ts and req.t_submit is not None:
                ttfts.append(ts[0] - req.t_submit)
        lay, pool = self.layout, self.pool
        out: Dict[str, float] = {
            "tokens": self.stats["tokens"],
            "decode_steps": self.stats["decode_steps"],
            "prefills": self.stats["prefills"],
            "preemptions": self.stats["preemptions"],
        }
        if self.layout.uses_pages:
            # cache memory ever allocated, in token slots; what one token
            # costs in pool bytes, and how many full-length users the pool
            # holds at once
            out["cache_tokens_allocated"] = \
                pool.total_allocs * lay.page_size
            out["kv_dtype"] = lay.kv_dtype_name
            out["kv_bytes_per_token"] = lay.kv_bytes_per_token()
            out["users_per_pool"] = (pool.num_pages - pool.reserved) \
                // lay.pages_for(lay.max_len)
        if gaps:
            out["p50_token_latency_s"] = float(np.percentile(gaps, 50))
            out["p95_token_latency_s"] = float(np.percentile(gaps, 95))
        if ttfts:
            out["p50_ttft_s"] = float(np.percentile(ttfts, 50))
            out["p95_ttft_s"] = float(np.percentile(ttfts, 95))
        occ = self.stats["occupancy"]
        if occ and self.layout.uses_pages:
            out["mean_internal_fragmentation"] = float(
                np.mean([o["internal_fragmentation"] for o in occ]))
            out["mean_pool_utilization"] = float(
                np.mean([o["utilization"] for o in occ]))
        return out

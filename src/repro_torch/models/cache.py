"""Cache layouts: how decode state is stored, addressed and updated (the
port of ``repro.models.cache`` for full and sliding-window attention,
MLA's latent cache, the Mamba state, the RG-LRU state and whisper's
cross blocks).

* `DenseLayout` — one contiguous ``(B, cache_len, KV, hd)`` buffer per
  layer (a ring ``(B, window, KV, hd)`` for a windowed kind, or the
  (B, ...) Mamba / RG-LRU state): `Model.prefill` / `Model.decode_step`
  as they are.
* `PagedLayout` — the layout behind continuous batching
  (`repro_torch.serve.scheduler`), per block kind (the tree mirrors the
  parameters': per stage, per block of its unit, stacked over the
  unit's repeats R):

  =================  ===================================================
  kind               storage
  =================  ===================================================
  attention (full)   pool ``(R, num_pages, page_size, KV, hd)`` for k and
                     v; logical position ``p`` of decode slot ``s`` is at
                     ``(block_table[s, p // page_size], p % page_size)``;
                     with ``kv_dtype`` int8/fp8 each token slot also
                     carries one f32 scale in ``*_scale`` pools ``(R,
                     num_pages, page_size)``
  mla                latent pools ``(R, num_pages, page_size,
                     kv_lora_rank)`` for ckv and ``(R, num_pages,
                     page_size, qk_rope_head_dim)`` for k_rope, through
                     the same block table (the latent cache is per
                     token); int8/fp8 add ``ckv_scale`` / ``k_rope_scale``
  attention w > 0    slot-indexed ring ``(R, n_slots, window, KV, hd)``
  (sliding, and      at the compute dtype: position ``p`` at slot ``p %
  attention_local)   window``, already O(window), nothing to page
  mamba / recurrent  slot-indexed O(1) state ``(R, n_slots, ...)``: conv
                     at the compute dtype, ssm / h f32, as the reference
                     keeps it (so under bf16 compute the slot's conv
                     state is rounded where the dense layout's is not)
  cross (whisper)    the self part paged as full attention; the
                     encoder's ``xk`` / ``xv`` slot-indexed ``(R,
                     n_slots, n_frames, H, hd)`` at the compute dtype,
                     written once by `PagedLayout.prefill_into`, static
                     after, never quantized, never copied by `copy_page`
  =================  ===================================================

  Row ``s`` of a slot-indexed kind is decode slot ``s``.  A model with no
  paged kind (falcon-mamba, recurrentgemma) never allocates a page.

The decode math stays in `repro_torch.models.attention`: the layout owns
the update and the view (`_PagedOps.kv_attend`, `_PagedOps.mla_update`).
The gather path feeds the paged linearized view, and the ring path the
slot's ring, to the same `attend_one` (`mla_attend_one`) as the dense
path, so at matched linearized cache lengths (rings are ``window`` wide
in both) and storage dtypes the two are bitwise equal.  The latent pages
are always read by the gather: the reference sends only full attention to
its kernel.
On a CUDA device the pages are read through the hand-written kernel
`repro_torch.kernels.paged_attention` instead of materializing the
``(B, max_pages * page_size, KV, hd)`` gather; on the CPU the gather is
the path.  ``use_kernel`` True or False forces one route on any device
(True on the CPU runs the kernel wrapper's plain version, as the
reference's ``use_kernel`` does; False on the card is the gather path the
kernel is checked against).  Pool writes are in place
(the torch form of the reference's buffer donation).

Chunked prefill (`PagedLayout.prefill_resume`, `_ChunkOps`): one chunk of
a prompt at absolute positions ``pos0 + [0, L)`` writes its k/v into the
pages its block table names and attends over the slot's linearized view.
On the card the view is gathered once per layer, up to the page holding
the chunk's last real position (dequantized to f32 for int8/fp8 pools,
cast to the queries' dtype), and handed to the flash-attention kernel with
``q_start = pos0``; on the CPU, and with ``Model(cfg, kernels=False)``, to
`repro_torch.models.attention.blocked_attention` at ``kv_chunk =
page_size``, the reference's route.  Both key blockings are aligned to
absolute key 0, and wholly masked key blocks are exact no-ops, so a row's
result does not depend on where its chunk starts: a prefix-cache hit that
resumes mid-prompt gives the cold chunked prefill's bits.  `copy_page` is
the device half of copy-on-write.  Rings and slot states cannot resume
mid-prompt, so a model with any of them is not ``chunkable``, as in the
reference; nor is a routed MoE model (its capacity drops depend on which
tokens share a batch), only one built with ``moe_dense``; nor are the
vlm and encdec models, whose prompts carry patches or frames.

Physical page 0 is the scratch page: inactive decode slots point their
whole block table at it (and sit at position 0), so their writes land
somewhere harmless and the step needs no per-slot mask.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core import quant as Q
from repro_torch.core.types import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.attention import attend_one, blocked_attention

Tree = Any

SCRATCH_PAGE = 0  # physical page inactive slots write into; never read


def _quantize_tokens(x: torch.Tensor, kv_dtype: str, lead: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-slot symmetric quantization for a page write: the first
    ``lead`` axes of ``x`` index token slots, the rest is the payload one
    token occupies — one f32 scale per slot, values in the storage dtype.
    Returns (values, scales with the slot shape)."""
    qv, sc = Q.quantize(x, kv_dtype, axes=tuple(range(lead, x.dim())))
    return qv, sc.reshape(x.shape[:lead])


_STATIC = ("xk", "xv")  # a cross block's slot-indexed encoder k / v


def resolved_window(cfg: ModelConfig, kind: str) -> int:
    """The sliding window a block kind attends with (0 = full causal, and
    0 for the ``mamba`` and ``recurrent`` kinds, which do not attend; a
    ``cross`` block's self-attention takes the config's)."""
    if kind == "attention_local":
        return cfg.rglru.attention_window
    if kind in ("attention", "cross"):
        return cfg.sliding_window
    if kind in ("mamba", "recurrent", "mla"):
        return 0
    raise ValueError(f"unknown block kind {kind!r}")


def stacked(c: dict, repeats: int) -> dict:
    """A per-block cache repeated on a leading unit axis, as the stage
    trees hold it."""
    return {name: t.unsqueeze(0).repeat((repeats,) + (1,) * t.dim())
            for name, t in c.items()}


def paged_kinds(cfg: ModelConfig, kinds) -> List[str]:
    """The block kinds of one stage unit whose cache grows with sequence
    length (and therefore lives in the page pool): full-causal attention,
    a cross block's self part, and mla; rings and the Mamba / RG-LRU
    states are slot-indexed."""
    return [k for k in kinds if k == "mla"
            or (k in ("attention", "cross") and resolved_window(cfg, k) == 0)]


def _scaled(lin: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A linearized view (B, C, ...) dequantized to f32 by its per-token
    scales (B, C)."""
    return lin.float() * scale.reshape(scale.shape + (1,) * (lin.dim() - 2))


# ---------------------------------------------------------------------------
# dense layout
# ---------------------------------------------------------------------------


class DenseLayout:
    """The contiguous per-sequence layout: the Model's own dense paths, so
    call sites select layouts uniformly."""

    def __init__(self, model):
        self.model = model

    def init_cache(self, batch: int, cache_len: int, dtype=None, *,
                   device) -> Tree:
        return self.model.init_cache(batch, cache_len, dtype, device=device)

    def prefill(self, params, batch, *, cache_len: int):
        return self.model.prefill(params, batch, cache_len=cache_len)

    def decode_step(self, params, cache, batch):
        return self.model.decode_step(params, cache, batch)


# ---------------------------------------------------------------------------
# paged layout
# ---------------------------------------------------------------------------


class _PagedOps:
    """The cache ops of one paged decode step: per-row positions and block
    tables, a page-pool scatter on write, and a block-table gather (or the
    CUDA kernel) on read; for a windowed kind, the slot's ring.  The write
    coordinates and the kernel's lengths are computed once per step on the
    device, for every layer."""

    def __init__(self, layout: "PagedLayout", pos: torch.Tensor,
                 block_tables: torch.Tensor):
        self.layout = layout
        self.pos = pos.long()                    # (B,)
        self.rows = torch.arange(self.pos.shape[0], device=self.pos.device)
        self._rings = {}                         # ring width -> (slot, valid)
        self.kernel = False
        if not layout.uses_pages:                # rings and slot states only
            return
        self.bt = block_tables.long()            # (B, max_pages)
        ps = layout.page_size
        self.phys = self.bt[self.rows, self.pos // ps]
        self.off = self.pos % ps
        self.kernel = layout.use_kernel if layout.use_kernel is not None \
            else self.pos.device.type == "cuda"
        if self.kernel:
            self.bt32 = block_tables.to(torch.int32)
            self.lengths = (self.pos + 1).to(torch.int32)

    def _ring(self, width: int):
        """(slot (B,), valid (B, width)) of a ring ``width`` wide: each row
        writes at ``pos % width`` and sees every slot up to ``pos`` (all of
        them once its ring has wrapped), the reference's slot ring."""
        if width not in self._rings:
            self._rings[width] = (
                self.pos % width,
                torch.arange(width, device=self.pos.device)[None, :]
                <= self.pos[:, None])
        return self._rings[width]

    def kv_attend(self, cache: dict, qg, k_new, v_new, *, window: int
                  ) -> Tuple[torch.Tensor, dict]:
        """Write the step's k/v (B, 1, KV, hd) at each row's position and
        attend over the row's pages, or over its ring for ``window > 0``.
        Returns ((B, KV, G, hd) f32, the cache)."""
        if window > 0:
            slot, valid = self._ring(cache["k"].shape[1])
            cache["k"][self.rows, slot] = k_new[:, 0].to(cache["k"].dtype)
            cache["v"][self.rows, slot] = v_new[:, 0].to(cache["v"].dtype)
            return attend_one(qg, cache["k"], cache["v"], valid), cache
        lay = self.layout
        at = (self.phys, self.off)
        scales = ()
        if lay.kv_quantized:
            kq, ksc = _quantize_tokens(k_new[:, 0], lay.kv_dtype, 1)
            vq, vsc = _quantize_tokens(v_new[:, 0], lay.kv_dtype, 1)
            cache["k"][at], cache["v"][at] = kq, vq
            cache["k_scale"][at], cache["v_scale"][at] = ksc, vsc
            scales = (cache["k_scale"], cache["v_scale"])
        else:
            cache["k"][at] = k_new[:, 0].to(cache["k"].dtype)
            cache["v"][at] = v_new[:, 0].to(cache["v"].dtype)
        if self.kernel:
            k_scale, v_scale = scales or (None, None)
            out = paged_attention(qg, cache["k"], cache["v"], self.bt32,
                                  self.lengths, k_scale=k_scale,
                                  v_scale=v_scale)
            return out, cache
        k_lin, valid = self._linearize(cache["k"], *scales[:1])
        v_lin, _ = self._linearize(cache["v"], *scales[1:])
        return attend_one(qg, k_lin, v_lin, valid), cache

    def mla_update(self, cache: dict, ckv_t, k_rope_t):
        """Write the step's latents (B, rank) and (B, rope) at each row's
        position (quantized per token with their scales for int8/fp8
        pools), then gather each row's latent pages.  Returns (ckv (B, C,
        rank), k_rope (B, C, rope), valid (B, C), the cache); the views
        are f32 when the pools are quantized."""
        at = (self.phys, self.off)
        names = (("ckv", ckv_t), ("k_rope", k_rope_t))
        for name, new in names:
            if self.layout.kv_quantized:
                qv, sc = _quantize_tokens(new, self.layout.kv_dtype, 1)
                cache[name][at] = qv
                cache[f"{name}_scale"][at] = sc
            else:
                cache[name][at] = new.to(cache[name].dtype)
        views = [self._linearize(cache[name], cache.get(f"{name}_scale"))
                 for name, _ in names]
        return views[0][0], views[1][0], views[0][1], cache

    def _linearize(self, pool: torch.Tensor,
                   scale: Optional[torch.Tensor] = None):
        """Gather each slot's pages into logical order: (B, max_pages *
        page_size, ...), the paged view of the dense cache.  With
        ``scale`` (the pool's per-token f32 scales) the view is
        dequantized to f32, so the attention math never sees the storage
        dtype."""
        B, mp = self.bt.shape
        ps = self.layout.page_size
        lin = pool[self.bt].reshape(B, mp * ps, *pool.shape[2:])
        if scale is not None:
            lin = _scaled(lin, scale[self.bt].reshape(B, mp * ps))
        valid = torch.arange(mp * ps, device=lin.device)[None, :] \
            <= self.pos[:, None]
        return lin, valid


class _ChunkOps:
    """The cache ops of one chunked-prefill dispatch: rows resuming their
    prompts at absolute ``positions`` = ``q_start + [0, L)`` (shared by the
    rows: chunk dispatches are per request, B = 1), writing L consecutive
    positions into pages and attending over the first ``n_view`` pages of
    each row's block table.  The write coordinates are computed once per
    dispatch, for every layer; the writes are in place."""

    def __init__(self, layout: "PagedLayout", positions: torch.Tensor,
                 block_tables: torch.Tensor, n_view: int, q_start: int):
        self.layout = layout
        self.bt = block_tables.long()            # (B, max_pages)
        self.view_bt = self.bt[:, :n_view]
        ps = layout.page_size
        mp = self.bt.shape[1]
        # the padded tail of a prompt's last chunk can run past the block
        # table: those writes go to the scratch page, not to the clamped
        # last entry
        safe = positions < mp * ps
        page = torch.clamp(positions // ps, max=mp - 1)
        self.phys = torch.where(safe[None], self.bt[:, page], SCRATCH_PAGE)
        self.off = (positions % ps)[None].expand_as(self.phys)
        self.q_start = q_start
        self.kernel = layout.model.kernels \
            and positions.device.type == "cuda"

    def _scatter(self, pool: torch.Tensor, new: torch.Tensor) -> None:
        """new: (B, L, ...) entries for ``positions``, written in place."""
        pool[self.phys, self.off] = new.to(pool.dtype)

    def _store(self, cache: dict, name: str, new: torch.Tensor) -> None:
        """Write ``new`` (B, L, ...) into pool ``name``: values and per-
        token scales when the pools are quantized, a cast otherwise."""
        if self.layout.kv_quantized:
            qv, sc = _quantize_tokens(new, self.layout.kv_dtype, 2)
            self._scatter(cache[name], qv)
            self._scatter(cache[f"{name}_scale"], sc)
        else:
            self._scatter(cache[name], new)

    def _view(self, cache: dict, name: str) -> torch.Tensor:
        """The linearized view (B, n_view * page_size, ...), dequantized
        to f32 when the pools are quantized."""
        B, n = self.view_bt.shape
        ps = self.layout.page_size
        pool = cache[name]
        lin = pool[self.view_bt].reshape(B, n * ps, *pool.shape[2:])
        if self.layout.kv_quantized:
            lin = _scaled(lin, cache[f"{name}_scale"][self.view_bt]
                          .reshape(B, n * ps))
        return lin

    def kv_prefill_attend(self, cache: dict, qg, k_new, v_new, positions
                          ) -> Tuple[torch.Tensor, dict]:
        """Write the chunk's k/v (B, L, KV, hd), then attend qg (B, L, KV,
        G, hd) over the view.  Returns ((B, L, KV, G, hd), the cache)."""
        self._store(cache, "k", k_new)
        self._store(cache, "v", v_new)
        k_lin, v_lin = self._view(cache, "k"), self._view(cache, "v")
        if self.kernel:
            out = flash_attention(qg, k_lin.to(qg.dtype), v_lin.to(qg.dtype),
                                  causal=True, q_start=self.q_start)
        else:
            out = blocked_attention(
                qg, k_lin, v_lin, positions,
                torch.arange(k_lin.shape[1], device=qg.device), causal=True,
                window=0, q_chunk=qg.shape[1],
                kv_chunk=self.layout.page_size)
        return out, cache

    def mla_prefill(self, cache: dict, ckv, k_rope):
        """Write the chunk's latents (B, L, ...) and return the views
        (ckv, k_rope) the chunk's queries attend over, and the cache."""
        self._store(cache, "ckv", ckv)
        self._store(cache, "k_rope", k_rope)
        return self._view(cache, "ckv"), self._view(cache, "k_rope"), cache


class PagedLayout:
    """Paged KV cache for continuous batching.

    ``n_slots`` — decode batch rows (one active request per slot);
    ``num_pages`` x ``page_size`` — the shared pool (page 0 = scratch);
    ``max_pages`` — block-table width = the most pages one slot holds;
    ``kv_dtype`` — storage dtype of the pools (the paged kinds only: the
    slot-indexed Mamba state stays at the compute dtype): None/"auto"
    keeps the compute dtype, a float name ("float32", "bfloat16", "float16")
    overrides it, ``int8``/``fp8`` quantize every page write per token
    slot with an f32 scale stored in a sibling ``*_scale`` pool, and
    reads dequantize (in the gather or in the kernel) so the attention
    math stays f32; ``use_kernel`` — None reads the pages through the
    CUDA kernel on the card and gathers them on the CPU, True or False
    forces one route.
    """

    def __init__(self, model, *, n_slots: int, num_pages: int,
                 page_size: int, max_pages: int,
                 use_kernel: Optional[bool] = None,
                 kv_dtype: Optional[str] = None):
        model._refuse_paged("a paged layout")
        self.model = model
        self.n_slots = int(n_slots)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self.use_kernel = None if use_kernel is None else bool(use_kernel)
        self.kv_dtype = None if kv_dtype in (None, "auto") \
            else Q.canonical(kv_dtype)
        self.kv_quantized = self.kv_dtype is not None \
            and Q.is_quantized(self.kv_dtype)
        cfg = model.cfg
        # False for a model of rings and slot states only (falcon-mamba,
        # recurrentgemma): no page is ever allocated and the pool stays
        # untouched
        self.uses_pages = any(paged_kinds(cfg, st.kinds)
                              for st in model.stages)
        # chunked prefill and prefix caching need every kind position-
        # addressable in pages: the paged kinds (full attention, mla) are;
        # rings and slot-indexed states cannot resume mid-prompt.  And
        # per-token FFN math: routed MoE drops tokens by batch occupancy,
        # so a chunk boundary would change the math
        # (a VLM's or an encoder-decoder's prompt carries patches or
        # frames that a chunk of tokens does not)
        self.chunkable = all(paged_kinds(cfg, st.kinds) == list(st.kinds)
                             for st in model.stages) \
            and (cfg.moe is None or model.moe_dense) \
            and cfg.vlm is None and cfg.encoder is None

    # -- allocation-free capacity facts ------------------------------------

    @property
    def max_len(self) -> int:
        """Longest sequence one block table can address."""
        return self.max_pages * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache positions (0 when no
        kind is paged)."""
        return -(-max(int(n_tokens), 1) // self.page_size) \
            if self.uses_pages else 0

    def _pool_dtype(self, dtype) -> torch.dtype:
        """Storage dtype of the paged pools (``dtype`` = compute dtype)."""
        if self.kv_dtype is None:
            return dtype
        if self.kv_quantized:
            return Q.qinfo(self.kv_dtype)[0]
        return Q.float_wire(self.kv_dtype)

    def kv_bytes_per_token(self) -> int:
        """Pool bytes one committed token slot occupies across every paged
        layer's pools (k and v, or mla's ckv and k_rope): the payload at
        the storage dtype plus one f32 scale per (pool, slot) when
        quantized (0 when no kind is paged)."""
        cfg = self.model.cfg
        it = self._pool_dtype(self.model.compute_dtype).itemsize
        sb = Q.SCALE_BYTES if self.kv_quantized else 0
        total = 0
        for st in self.model.stages:
            for kind in paged_kinds(cfg, st.kinds):
                feats = (cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim) \
                    if kind == "mla" else \
                    (cfg.eff_n_kv_heads * cfg.resolved_head_dim,) * 2
                total += st.repeats * sum(f * it + sb for f in feats)
        return total

    def page_bytes(self) -> int:
        """Pool bytes one physical page pins across every paged layer."""
        return self.kv_bytes_per_token() * self.page_size

    @property
    def kv_dtype_name(self) -> str:
        return self.kv_dtype if self.kv_dtype is not None \
            else str(self.model.compute_dtype).replace("torch.", "")

    # -- cache init ---------------------------------------------------------

    def init_cache(self, dtype=None, *, device) -> Tree:
        """Zeroed storage in the reference's tree, per stage and block of
        its unit, stacked over the unit's repeats R: the pools ``{"k",
        "v": (R, num_pages, page_size, KV, hd)[, "k_scale", "v_scale":
        (R, num_pages, page_size)]}`` for full attention, ``{"ckv",
        "k_rope"[, "ckv_scale", "k_rope_scale"]}`` likewise for mla, the
        slot-indexed
        ring ``(R, n_slots, window, KV, hd)`` of a windowed kind, or the
        Mamba / RG-LRU state ``(R, n_slots, ...)``."""
        dtype = dtype or self.model.compute_dtype
        return [{f"b{j}": self._init_block(kind, stage.repeats, dtype,
                                           device)
                 for j, kind in enumerate(stage.kinds)}
                for stage in self.model.stages]

    def _init_block(self, kind: str, repeats: int, dtype, device) -> dict:
        cfg = self.model.cfg
        if not paged_kinds(cfg, (kind,)):     # slot-indexed, at ``dtype``
            return stacked(self.model.init_block_cache(
                kind, self.n_slots, 0, dtype, device), repeats)
        lead = (repeats, self.num_pages, self.page_size)
        feats = {"ckv": (cfg.mla.kv_lora_rank,),
                 "k_rope": (cfg.mla.qk_rope_head_dim,)} if kind == "mla" \
            else {n: (cfg.eff_n_kv_heads, cfg.resolved_head_dim)
                  for n in ("k", "v")}
        c = {n: torch.zeros(lead + f, dtype=self._pool_dtype(dtype),
                            device=device) for n, f in feats.items()}
        if self.kv_quantized:
            for n in feats:
                c[f"{n}_scale"] = torch.zeros(lead, dtype=torch.float32,
                                              device=device)
        if kind == "cross":      # the encoder's k / v, one row per slot
            shape = (repeats, self.n_slots, cfg.encoder.n_frames,
                     cfg.eff_n_heads, cfg.resolved_head_dim)
            for n in _STATIC:
                c[n] = torch.zeros(shape, dtype=dtype, device=device)
        return c

    # -- prefill-on-join ----------------------------------------------------

    def prefill_into(self, params, cache: Tree, batch: dict,
                     pages: torch.Tensor,
                     slots: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Tree]:
        """Prefill a GROUP of joining requests (equal prompt lengths, one
        batch row each) and write their caches in place: full attention's
        k/v into ``pages`` ((k, n_pg) physical page ids covering each
        prompt), rings, the Mamba / RG-LRU states and the encoder's xk /
        xv into slot rows ``slots`` ((k,) decode slots; needed only by
        slot-indexed kinds).  A VLM's prompt is its patches, then its
        tokens: the pages must cover both.

        Runs `Model.prefill` as it is — the dense cache entries it returns
        are the logical layout (its rings ``window`` wide, as the slots'
        are), scattered here into the pool and slot storage — so a paged
        prefill is bitwise the dense prefill at the same batch width."""
        P = batch["tokens"].shape[1]
        if self.model.cfg.vlm is not None and "patches" in batch:
            P += batch["patches"].shape[1]
        n_pg = int(pages.shape[1])
        if self.uses_pages and n_pg * self.page_size < P:
            # (the reference sizes its cache from the tokens alone)
            raise ValueError(f"prefill_into: {n_pg} pages of "
                             f"{self.page_size} hold fewer than the "
                             f"prompt's {P} positions")
        cache_len = max(n_pg * self.page_size, P, 1)
        logits, entries = self.model.prefill(params, batch,
                                             cache_len=cache_len)
        for si, stage in enumerate(self.model.stages):
            for j, kind in enumerate(stage.kinds):
                self._write_block(kind, cache[si][f"b{j}"],
                                  entries[si][f"b{j}"], pages, slots)
        return logits, cache

    def _write_block(self, kind: str, c: dict, e: dict,
                     pages: torch.Tensor,
                     slots: Optional[torch.Tensor]) -> None:
        paged = bool(paged_kinds(self.model.cfg, (kind,)))
        slot_names = [n for n in c if not paged or n in _STATIC]
        if slot_names:
            # to_slot: (R, k, ...) into the joining slots' rows
            if slots is None:
                raise ValueError(f"prefill_into: the {kind} cache is "
                                 "slot-indexed, pass the joining slots")
            rows = slots.reshape(-1).long()
            for name in slot_names:
                c[name][:, rows] = e[name].to(c[name].dtype)
        if not paged:
            return
        ps = self.page_size
        k_grp, n_pg = pages.shape
        flat = pages.reshape(-1).long()
        for name in (n for n in e if n not in _STATIC):
            seq = e[name]                       # (R, k, cache_len, ...)
            seg = seq[:, :, :n_pg * ps].reshape(
                seq.shape[0], k_grp * n_pg, ps, *seq.shape[3:])
            if self.kv_quantized:
                qv, sc = _quantize_tokens(seg, self.kv_dtype, 3)
                c[name][:, flat] = qv
                c[f"{name}_scale"][:, flat] = sc
            else:
                c[name][:, flat] = seg.to(c[name].dtype)

    # -- chunked prefill (mid-prompt resume) --------------------------------

    def prefill_resume(self, params, cache: Tree, tokens: torch.Tensor,
                       pos0: int, last, block_tables: torch.Tensor
                       ) -> Tuple[torch.Tensor, Tree]:
        """Prefill one chunk of a prompt, resuming mid-prompt: ``tokens``
        (B, L) at absolute positions ``pos0 + [0, L)`` (``pos0`` a host
        int, the same for every row: chunk dispatches are per request,
        B = 1), writing into the pages ``block_tables`` (B, max_pages)
        names and attending over everything already there.  ``last`` (a
        host int or (B,) ints) indexes each row's last real position in
        the chunk (the tail may be padding); the logits are taken there.
        Every dispatch of a scheduler has the same shapes, (1,
        prefill_chunk) tokens and the full-width table.  Returns
        ((B, vocab_padded) f32 logits, the cache updated in place)."""
        if not self.chunkable:
            raise NotImplementedError(
                f"{self.model.cfg.name}: chunked prefill needs every cache "
                "kind paged (attention/MLA, window 0) and per-token FFN "
                "math — use whole-prompt prefill_into")
        dev = tokens.device
        L = tokens.shape[1]
        pos0 = int(pos0)
        last = torch.as_tensor(last, dtype=torch.long).reshape(-1)
        mp = block_tables.shape[1]
        # the view stops at the page of the chunk's last real position:
        # nothing after it is live for any real row
        n_view = min(mp, (pos0 + int(last.max())) // self.page_size + 1)
        positions = pos0 + torch.arange(L, device=dev)
        ops = _ChunkOps(self, positions, block_tables, n_view, pos0)
        return self.model.prefill_chunk(
            params, cache, {"tokens": tokens,
                            "last": last.to(dev).expand(tokens.shape[0])},
            positions=positions, cache_ops=ops)

    def copy_page(self, cache: Tree, src: int, dst: int) -> Tree:
        """Copy physical page ``src`` to ``dst`` in every paged pool (values
        and scales, every layer), in place: the device half of
        copy-on-write (the host swaps the block-table entry and drops the
        shared reference)."""
        for si, stage in enumerate(self.model.stages):
            for j, kind in enumerate(stage.kinds):
                if paged_kinds(self.model.cfg, (kind,)):
                    for name, pool in cache[si][f"b{j}"].items():
                        if name not in _STATIC:
                            pool[:, dst] = pool[:, src]
        return cache

    # -- decode -------------------------------------------------------------

    def decode_step(self, params, cache: Tree, tokens: torch.Tensor,
                    pos: torch.Tensor, block_tables: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tree]:
        """One continuous-batching decode step: ``tokens`` (B, 1), ``pos``
        (B,) per-slot positions, ``block_tables`` (B, max_pages), all on
        the device.  Returns ((B, vocab_padded) logits, the cache updated
        in place).  Decode row s is slot s's row of every slot-indexed
        kind.  A VLM's M-RoPE positions are (3, B, 1), each row's ``pos``
        in all three components."""
        ops = _PagedOps(self, pos, block_tables)
        batch = {"tokens": tokens, "pos": ops.pos}
        if self.model.cfg.vlm is not None:
            batch["mrope_positions"] = ops.pos[None, :, None].expand(
                3, -1, 1)
        return self.model.decode_step(params, cache, batch, cache_ops=ops)

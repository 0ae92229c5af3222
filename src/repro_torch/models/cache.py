"""Cache layouts: how decode state is stored, addressed and updated (the
port of ``repro.models.cache`` for full causal attention and the Mamba
state).

* `DenseLayout` — one contiguous ``(B, cache_len, KV, hd)`` buffer per
  layer (or the (B, ...) Mamba state): `Model.prefill` /
  `Model.decode_step` as they are.
* `PagedLayout` — the layout behind continuous batching
  (`repro_torch.serve.scheduler`), per block kind: attention's k and v
  live in a shared pool ``(L, num_pages, page_size, KV, hd)``; logical
  position ``p`` of decode slot ``s`` is at ``(block_table[s, p //
  page_size], p % page_size)``.  With ``kv_dtype`` int8/fp8 each token
  slot also carries one f32 scale in ``*_scale`` pools ``(L, num_pages,
  page_size)``.  The Mamba state is O(1) per sequence and slot-indexed:
  ``(L, n_slots, ...)``, row ``s`` for decode slot ``s``, never paged, at
  the compute dtype for conv and f32 for ssm as the reference keeps it
  (so under bf16 compute the slot's conv state is rounded where the dense
  layout's is not).

The decode math stays in `repro_torch.models.attention`: the layout owns
the update and the view (`_PagedOps.kv_attend`).  The gather path feeds
the paged linearized view to the same `attend_one` as the dense path, so
at matched linearized cache lengths the two are bitwise equal.
On a CUDA device the pages are read through the hand-written kernel
`repro_torch.kernels.paged_attention` instead of materializing the
``(B, max_pages * page_size, KV, hd)`` gather; on the CPU the gather is
the path.  ``use_kernel`` True or False forces one route on any device
(True on the CPU runs the kernel wrapper's plain version, as the
reference's ``use_kernel`` does; False on the card is the gather path the
kernel is checked against).  Pool writes are in place
(the torch form of the reference's buffer donation).

Physical page 0 is the scratch page: inactive decode slots point their
whole block table at it (and sit at position 0), so their writes land
somewhere harmless and the step needs no per-slot mask.

Not ported yet: the MLA, ring and RG-LRU kinds (ROADMAP A6), and
chunked prefill with prefix pages — ``_ChunkOps``, ``prefill_resume``,
``copy_page`` (ROADMAP A11).  ``chunkable`` is False until then.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core import quant as Q
from repro_torch.core.types import ModelConfig
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.attention import attend_one

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


_PORTED_KINDS = ("attention", "mamba")


def resolved_window(cfg: ModelConfig, kind: str) -> int:
    """The sliding window a block kind attends with (0 = full causal, and
    0 for ``mamba``, which does not attend).  Only the ``attention`` and
    ``mamba`` kinds are ported (ROADMAP A6)."""
    if kind not in _PORTED_KINDS:
        raise NotImplementedError(f"{kind!r} blocks are not ported "
                                  "(ROADMAP A6)")
    return cfg.sliding_window if kind == "attention" else 0


def paged_kinds(cfg: ModelConfig, kinds) -> List[str]:
    """The block kinds of one stage unit whose cache grows with sequence
    length (and therefore lives in the page pool): full-causal attention;
    the Mamba state is slot-indexed."""
    return [k for k in kinds
            if resolved_window(cfg, k) == 0 and k == "attention"]


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
    CUDA kernel) on read.  The write coordinates and the kernel's lengths
    are computed once per step on the device, for every layer."""

    def __init__(self, layout: "PagedLayout", pos: torch.Tensor,
                 block_tables: torch.Tensor):
        self.layout = layout
        self.pos = pos.long()                    # (B,)
        self.bt = block_tables.long()            # (B, max_pages)
        ps = layout.page_size
        rows = torch.arange(self.bt.shape[0], device=self.bt.device)
        self.phys = self.bt[rows, self.pos // ps]
        self.off = self.pos % ps
        self.kernel = layout.use_kernel if layout.use_kernel is not None \
            else self.pos.device.type == "cuda"
        if self.kernel:
            self.bt32 = block_tables.to(torch.int32)
            self.lengths = (self.pos + 1).to(torch.int32)

    def kv_attend(self, cache: dict, qg, k_new, v_new, *, window: int
                  ) -> Tuple[torch.Tensor, dict]:
        """Write the step's k/v (B, 1, KV, hd) at each row's position and
        attend over the row's pages.  Returns ((B, KV, G, hd) f32, the
        cache)."""
        if window > 0:
            raise NotImplementedError(
                "the slot-indexed sliding-window ring is not ported "
                "(ROADMAP A6)")
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

    def _linearize(self, pool: torch.Tensor,
                   scale: Optional[torch.Tensor] = None):
        """Gather each slot's pages into logical order: (B, max_pages *
        page_size, KV, hd), the paged view of the dense cache.  With
        ``scale`` (the pool's per-token f32 scales) the view is
        dequantized to f32, so the attention math never sees the storage
        dtype."""
        B, mp = self.bt.shape
        ps = self.layout.page_size
        lin = pool[self.bt].reshape(B, mp * ps, *pool.shape[2:])
        if scale is not None:
            lin = lin.float() * scale[self.bt].reshape(B, mp * ps, 1, 1)
        valid = torch.arange(mp * ps, device=lin.device)[None, :] \
            <= self.pos[:, None]
        return lin, valid


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
        # False for a slot-state-only model (falcon-mamba): no page is
        # ever allocated and the pool stays untouched
        self.uses_pages = bool(paged_kinds(model.cfg, (model.kind,)))
        # chunked prefill / prefix caching wait for _ChunkOps (ROADMAP A11)
        self.chunkable = False

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
        layer's k and v pools: the payload at the storage dtype plus one
        f32 scale per (pool, slot) when quantized (0 when no kind is
        paged)."""
        cfg = self.model.cfg
        if not self.uses_pages:
            return 0
        it = self._pool_dtype(self.model.compute_dtype).itemsize
        sb = Q.SCALE_BYTES if self.kv_quantized else 0
        return cfg.n_layers * 2 * (cfg.eff_n_kv_heads
                                   * cfg.resolved_head_dim * it + sb)

    def page_bytes(self) -> int:
        """Pool bytes one physical page pins across every paged layer."""
        return self.kv_bytes_per_token() * self.page_size

    @property
    def kv_dtype_name(self) -> str:
        return self.kv_dtype if self.kv_dtype is not None \
            else str(self.model.compute_dtype).replace("torch.", "")

    # -- cache init ---------------------------------------------------------

    def init_cache(self, dtype=None, *, device) -> Tree:
        """Zeroed storage with the layers as the leading axis, in the
        reference's tree: ``[{"b0": {"k": (L, num_pages, page_size, KV,
        hd), "v": ..., ["k_scale", "v_scale": (L, num_pages,
        page_size)]}}]`` for attention, ``[{"b0": {"conv": (L, n_slots,
        K-1, E), "ssm": (L, n_slots, E, N)}}]`` for mamba."""
        dtype = dtype or self.model.compute_dtype
        if not self.uses_pages:     # the slot-indexed Mamba state
            return self.model.init_cache(self.n_slots, 0, dtype,
                                         device=device)
        pdt = self._pool_dtype(dtype)
        cfg = self.model.cfg
        shape = (cfg.n_layers, self.num_pages, self.page_size,
                 cfg.eff_n_kv_heads, cfg.resolved_head_dim)
        c = {n: torch.zeros(shape, dtype=pdt, device=device)
             for n in ("k", "v")}
        if self.kv_quantized:
            for n in ("k_scale", "v_scale"):
                c[n] = torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device)
        return [{"b0": c}]

    # -- prefill-on-join ----------------------------------------------------

    def prefill_into(self, params, cache: Tree, batch: dict,
                     pages: torch.Tensor,
                     slots: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Tree]:
        """Prefill a GROUP of joining requests (equal prompt lengths, one
        batch row each) and write their caches in place: attention's k/v
        into ``pages`` ((k, n_pg) physical page ids covering each prompt),
        the Mamba state into slot rows ``slots`` ((k,) decode slots;
        needed only by slot-indexed kinds).

        Runs `Model.prefill` as it is — the dense cache entries it returns
        are the logical layout, scattered here into the pool and slot
        storage — so a paged prefill is bitwise the dense prefill at the
        same batch width."""
        P = batch["tokens"].shape[1]
        n_pg = int(pages.shape[1])
        cache_len = max(n_pg * self.page_size, P, 1)
        logits, entries = self.model.prefill(params, batch,
                                             cache_len=cache_len)
        self._write_block(cache[0]["b0"], entries[0]["b0"], pages, slots)
        return logits, cache

    def _write_block(self, c: dict, e: dict, pages: torch.Tensor,
                     slots: Optional[torch.Tensor]) -> None:
        if not self.uses_pages:     # to_slot: (L, k, ...) into the slots
            if slots is None:
                raise ValueError("prefill_into: the mamba state is "
                                 "slot-indexed, pass the joining slots")
            rows = slots.reshape(-1).long()
            for name, buf in c.items():
                buf[:, rows] = e[name].to(buf.dtype)
            return
        ps = self.page_size
        k_grp, n_pg = pages.shape
        flat = pages.reshape(-1).long()
        for name in ("k", "v"):
            seq = e[name]                       # (R, k, cache_len, KV, hd)
            seg = seq[:, :, :n_pg * ps].reshape(
                seq.shape[0], k_grp * n_pg, ps, *seq.shape[3:])
            if self.kv_quantized:
                qv, sc = _quantize_tokens(seg, self.kv_dtype, 3)
                c[name][:, flat] = qv
                c[f"{name}_scale"][:, flat] = sc
            else:
                c[name][:, flat] = seg.to(c[name].dtype)

    # -- decode -------------------------------------------------------------

    def decode_step(self, params, cache: Tree, tokens: torch.Tensor,
                    pos: torch.Tensor, block_tables: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tree]:
        """One continuous-batching decode step: ``tokens`` (B, 1), ``pos``
        (B,) per-slot positions, ``block_tables`` (B, max_pages), all on
        the device.  Returns ((B, vocab_padded) logits, the cache updated
        in place)."""
        if not self.uses_pages:     # decode row s is slot s's state row
            return self.model.decode_step(params, cache,
                                          {"tokens": tokens, "pos": pos})
        ops = _PagedOps(self, pos, block_tables)
        return self.model.decode_step(params, cache,
                                      {"tokens": tokens, "pos": ops.pos},
                                      cache_ops=ops)

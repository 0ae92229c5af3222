"""Grouped-query attention, causal, full or sliding-window, or
bidirectional (the port of ``repro.models.attention``'s
``init_attention`` / ``init_cross_attention`` / ``attention_train``, for
decoding ``init_kv_cache`` / ``decode_positions`` / ``attend_one`` /
``attention_decode`` with the ring buffer of a windowed kind, and for
chunked prefill ``_blocked_attention`` / ``attention_prefill_chunk``).

The full-sequence attention core has two routes, chosen by the caller
(``core``): ``"plain"`` (`blocked_attention`, the reference's
``_blocked_attention``: an online softmax over (``q_chunk`` x
``kv_chunk``) blocks, so no (S, S) score tensor is ever whole) for
training, whose gradients autograd takes through it; and ``"flash"``,
the hand-written kernel
`repro_torch.kernels.flash_attention` (its plain version on the CPU),
forward only, for the prefill.  Both take the sliding ``window`` (keys
``window`` or more before the query are masked): a dense config's
``sliding_window`` or a hybrid's ``attention_local`` window.

Decoding writes the new token's k/v into the cache in place (the torch
form of the reference's buffer donation).  A windowed kind's cache is a
ring: the token at position ``pos`` goes to slot ``pos % ring_width`` and
every slot up to ``pos`` is live (all of them once the ring has wrapped),
so the memory is O(window), not O(sequence).  A prompt's chunk
(`attention_prefill_chunk`) writes its k/v into the paged cache and
attends over the cache's linearized view through the layout's ops: the
flash-attention kernel with a query offset on the card,
`blocked_attention` (the reference's online softmax over fixed key
blocks) on the CPU.  Multi-head latent attention (MiniCPM3) has the
same three paths over a latent cache: `mla_train` (the plain core at a
q·k width other than v's), the absorbed one-token `mla_decode` and
`mla_prefill_chunk`.  Qwen2-VL's M-RoPE replaces RoPE on q and k where
the caller passes ``mrope_positions``.  Whisper's cross-attention is
`attention_train` with ``kv_override`` (the encoder's k and v, projected
by the caller: no RoPE, no k norm, every frame visible, ``causal=False``)
and `attention_decode` with ``cross=True`` over the static per-request
encoder cache.
"""
from __future__ import annotations

import torch

import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       init_rmsnorm, matmul, promoted,
                                       rmsnorm, row_matmul)
from repro_torch.parallel.tensor import write_owned

NEG_INF = -1e30
MLA_KEY_BLOCK = 256  # keys per block of an MLA chunk's attention


def init_attention(gen: torch.Generator, lead, d: int, n_heads: int,
                   n_kv: int, head_dim: int, qk_norm: bool, dtype) -> dict:
    """Weights with a leading stacked-layer shape ``lead``."""
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, n_heads, head_dim), dtype,
                         in_axis_size=d),
        "wk": dense_init(gen, lead + (d, n_kv, head_dim), dtype,
                         in_axis_size=d),
        "wv": dense_init(gen, lead + (d, n_kv, head_dim), dtype,
                         in_axis_size=d),
        "wo": dense_init(gen, lead + (n_heads, head_dim, d), dtype,
                         in_axis_size=n_heads * head_dim),
    }
    if qk_norm:
        p["q_norm"] = init_rmsnorm(lead + (head_dim,), dtype, gen.device)
        p["k_norm"] = init_rmsnorm(lead + (head_dim,), dtype, gen.device)
    return p


def init_cross_attention(gen: torch.Generator, lead, d: int, n_heads: int,
                         head_dim: int, dtype) -> dict:
    """Cross-attention weights: multi-head (KV = H), no qk norm."""
    return init_attention(gen, lead, d, n_heads, n_heads, head_dim, False,
                          dtype)


def project(x: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') with jnp promotion: x (..., d) through a
    per-head weight (d, H, k) to (..., H, k); ``tp``: ``w`` holds this
    rank's heads (`layers.matmul`)."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k), tp).reshape(*x.shape[:-1], h, k)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int = 0, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd).  Causal (Sq = Sk),
    and with ``window > 0`` keys ``window`` or more before the query
    masked too; with ``causal=False`` every key is visible (Sq and Sk
    free).  Scores and softmax in f32 over the whole (Sq, Sk) at once.
    Returns (B, Sq, KV, G, vd) in q's dtype."""
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqkgh,bckh->bkgqc", q.float(), k.float()) \
        * (hd ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        if window > 0:
            mask = mask.triu(1 - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: int, q_chunk: int,
                      kv_chunk: int, ordered: bool = False) -> torch.Tensor:
    """The reference's ``_blocked_attention``: q (B, Sq, KV, G, hd); k, v
    (B, Sk, KV, hd); q_pos (Sq,) and k_pos (Sk,) absolute positions.  An
    online softmax over key blocks of ``kv_chunk``, in order; each block
    is taken by the rows of every query chunk at once (the reference
    scans its query chunks with the same body), so the launches grow with
    the key blocks only and no (Sq, Sk) score tensor is ever whole.
    Scores, their scale and the softmax in f32, the probabilities rounded
    to v's dtype before the PV product.  Padded queries sit at position
    -1, padded keys at 2^30 (masked).  A wholly masked key block after a
    live one is an exact no-op, so a row's result does not depend on how
    many blocks follow its last live key; one before every live one is
    wiped exactly by the first live block's correction, exp(-1e30 - m) =
    0.  ``ordered``: q_pos and k_pos are 0 .. Sq - 1 and 0 .. Sk - 1 (a
    training or prefill stream), so with ``causal`` the query chunks
    before the one that holds key block j's first key are done at block
    j: they leave the accumulators, and the blocks after it are not
    computed for them (the same bits, forward and backward, for about
    half the work).  The running maximum is held fixed in the backward
    pass, as flash attention's is (the result does not depend on it).
    With ``ordered`` and one key block (Sk <= ``kv_chunk``) the online
    softmax is a plain softmax over the row, and it is computed as one
    (`causal_attention`: the probabilities normalised before the PV
    product, one softmax backward), the same function with fewer
    launches (`chip_smoke.py`'s `_one_block_ab` times both on the card).
    Returns (B, Sq, KV, G, vd) in q's dtype."""
    B, Sq, KV, G, hd = q.shape
    Sk, vd = k.shape[1], v.shape[-1]
    if ordered and Sk <= kv_chunk:
        return causal_attention(q, k, v, window, causal)
    scale = hd ** -0.5
    pq, pk = (-Sq) % q_chunk, (-Sk) % kv_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq), value=-1)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        k_pos = F.pad(k_pos, (0, pk), value=2 ** 30)
    dtype, q = q.dtype, q.float()
    rows = Sq + pq
    m = torch.full((B, KV, G, rows), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, G, rows), device=q.device)
    acc = torch.zeros((B, KV, G, rows, vd), device=q.device)
    done, lo = [], 0          # the finished rows' outputs; the first live row

    def finish(n):
        out = acc[..., :n, :] / l[..., :n].clamp_min(1e-30)[..., None]
        done.append(out.permute(0, 3, 1, 2, 4))      # (B, n, KV, G, vd)

    for j0 in range(0, Sk + pk, kv_chunk):
        if ordered and causal:
            # rows before the chunk of query j0 see no key from j0 on
            start = min(j0 // q_chunk * q_chunk, rows)
            if start > lo:
                finish(start - lo)
                m, l, acc = m[..., start - lo:], l[..., start - lo:], \
                    acc[..., start - lo:, :]
                lo = start
            if lo == rows:
                break
        qp, kp = q_pos[lo:], k_pos[j0:j0 + kv_chunk]
        # True where a key is hidden from a row
        dead = (kp >= 2 ** 30)[None, :]
        if causal:
            dead = dead | (qp[:, None] < kp[None, :])
        if window > 0:
            dead = dead | ((qp[:, None] - kp[None, :]) >= window)
        kc, vc = k[:, j0:j0 + kv_chunk], v[:, j0:j0 + kv_chunk]
        s = torch.einsum("bqkgh,bckh->bkgqc", q[:, lo:], kc.float()) * scale
        s = s.masked_fill(dead, NEG_INF)
        # the running max carries no gradient: the result does not
        # depend on it, so all that would flow through it is the
        # cancellation noise of its exactly-zero gradient
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(vc.dtype).float(),
                          vc.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    if lo < rows:
        finish(rows - lo)
    return torch.cat(done, dim=1)[:, :Sq].to(dtype)


def attention_train(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    *, rope_theta: float, causal: bool = True,
                    window: int = 0, qk_norm: bool = False,
                    norm_eps: float = 1e-6, mrope_positions=None,
                    mrope_sections=None, kv_override=None,
                    return_kv: bool = False, core: str = "plain",
                    tp=None, kv_sharded: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024):
    """x: (B, S, d); positions: (S,).  Self-attention, causal unless
    ``causal=False``, over the last ``window`` positions when ``window >
    0``; ``mrope_positions`` (3, S) rotates q and k by M-RoPE in place of
    RoPE.  ``kv_override`` = (k, v) (B, Sk, KV, hd), already projected,
    makes it cross-attention: keys at ``arange(Sk)``, no RoPE and no k
    norm on them.  Returns (B, S, d), and with ``return_kv`` also the
    (normed, roped) k and v (B, S, KV, hd) that a decode cache stores.
    ``core``: ``"plain"`` (`blocked_attention` over blocks of
    ``min(q_chunk, S)`` queries and ``min(kv_chunk, Sk)`` keys, as the
    reference's ``attention_train``; differentiable) or ``"flash"`` (the
    flash-attention kernel's wrapper, forward only).

    With ``tp`` (a `repro_torch.parallel.tensor.ModelAxis`) ``wq`` and
    ``wo`` hold this rank's heads: q on the local heads, ``wo``
    row-parallel, its partials summed over the axis.
    ``kv_sharded`` says whether ``wk`` / ``wv`` hold local KV heads too;
    where they cannot (granite-20b, recurrentgemma: one KV head) they
    stay whole, every rank computes the whole k and v, and each takes the
    KV heads its query heads read; ``return_kv`` then returns the whole k
    and v (the prefill cuts them by position), else the local KV
    heads'.  A ``kv_override`` is the local heads' k and v, which the
    caller projected through its local columns (the cross-attention's
    ``wk`` / ``wv`` of the encoder output).  The
    replicated q / k norm scales enter the sharded heads through
    `ModelAxis.copy`, as do x (in each product, `layers.matmul`) and a
    whole k / v, so each gradient is summed over the axis exactly
    once."""
    if core not in ("plain", "flash"):
        raise ValueError(f"attention core {core!r}: 'plain' or 'flash'")
    B, S, _ = x.shape
    q = project(x, params["wq"], tp)
    if kv_override is None:
        tk = tp if kv_sharded else None
        k = project(x, params["wk"], tk)
        v = project(x, params["wv"], tk)
    else:
        k, v = kv_override
    if qk_norm:
        q = rmsnorm(_edge(params["q_norm"], tp), q, norm_eps)
        if kv_override is None:
            k = rmsnorm(_edge(params["k_norm"], tp if kv_sharded else None),
                        k, norm_eps)
    if rope_theta > 0 and kv_override is None:
        if mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, rope_theta, mrope_sections)
            k = apply_mrope(k, mrope_positions, rope_theta, mrope_sections)
        else:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
    kv = (k, v)
    if tp is not None and not kv_sharded and kv_override is None:
        k, v = _local_kv(tp.copy(k), tp.copy(v), q.shape[2], tp)
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    qg = q.reshape(B, S, KV, H // KV, hd)
    if core == "flash":
        out = flash_attention(qg, k, v, causal=causal, window=window)
    else:
        Sk = k.shape[1]
        k_pos = positions if kv_override is None \
            else torch.arange(Sk, device=x.device)
        # the stream's positions are 0 .. S - 1 (`Model._backbone`)
        out = blocked_attention(qg, k, v, positions, k_pos, causal=causal,
                                window=window, q_chunk=min(q_chunk, S),
                                kv_chunk=min(kv_chunk, Sk), ordered=True)
    wo = params["wo"]
    y = row_matmul(out.reshape(B, S, H * hd),
                   wo.reshape(H * hd, wo.shape[-1]), tp)
    return (y, *kv) if return_kv else y


def _edge(norm: dict, tp) -> dict:
    """A replicated norm's parameters as sharded heads read them."""
    return norm if tp is None else {n: tp.copy(w) for n, w in norm.items()}


def _local_kv(k: torch.Tensor, v: torch.Tensor, h_local: int, tp):
    """The KV heads of whole k / v (B, S, KV, hd) that this rank's
    ``h_local`` query heads read (global heads ``rank·h_local`` on, each
    reading KV head ``head // G``, G = H / KV): a block of KV heads when
    ``h_local`` spans whole groups, the one KV head of the group when it
    lies inside one."""
    KV = k.shape[2]
    G = h_local * tp.size // KV
    first = tp.rank * h_local
    if h_local % G == 0:
        lo, n = first // G, h_local // G
    elif G % h_local == 0:
        lo, n = first // G, 1
    else:
        raise ValueError(f"{h_local} query heads a rank straddle groups of "
                         f"{G} over {KV} KV heads")
    return k[:, :, lo:lo + n], v[:, :, lo:lo + n]


# ---------------------------------------------------------------------------
# one-token decode against a KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype, device) -> dict:
    """Zeroed dense k and v caches (batch, cache_len, n_kv, head_dim)."""
    shape = (batch, cache_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_positions(pos: torch.Tensor) -> torch.Tensor:
    """Positions for RoPE at decode: a 0-d ``pos`` (the dense layout, every
    row at the same position) becomes (1,); a per-row (B,) vector (the
    paged layout) becomes (B, 1)."""
    return pos[None] if pos.dim() == 0 else pos[:, None]


def attend_one(qg: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention core.  qg: (B, KV, G, hd); k/v caches:
    (B, C, KV, hd); valid: (C,) shared or (B, C) per-row mask.  Returns
    (B, KV, G, hd) f32.  Shared by the dense and paged cache layouts, so
    the two are bitwise equal on matched inputs.  The probabilities are
    rounded to the cache dtype before the PV product, as the reference
    does (at bf16 this is where the gather path and the paged kernel,
    which keeps them in f32, part)."""
    hd = qg.shape[-1]
    s = torch.einsum("bkgh,bckh->bkgc", qg.float(), k_cache.float()) \
        * (hd ** -0.5)
    mask = valid[None] if valid.dim() == 1 else valid
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgc,bckh->bkgh", p.to(v_cache.dtype).float(),
                        v_cache.float())


def attention_decode(params: dict, cache: dict, x: torch.Tensor,
                     pos: torch.Tensor, *, rope_theta: float,
                     window: int = 0, qk_norm: bool = False,
                     norm_eps: float = 1e-6, mrope_positions=None,
                     mrope_sections=None, cross: bool = False,
                     cache_ops=None, tp=None, kv_sharded: bool = True,
                     seq=None):
    """One-token decode.  x: (B, 1, d); pos: 0-d int tensor (the dense
    layout) or a per-row (B,) vector under a paged layout, on x's device;
    ``mrope_positions`` ((3, 1) dense, (3, B, 1) paged) rotates q and the
    new k by M-RoPE in place of RoPE.

    Cache keys are stored post-RoPE.  For ``window > 0`` the cache is a
    ring (slot ``pos % cache_len``, every slot up to ``pos`` live).
    ``cache_ops`` (a `repro_torch.models.cache` layout's step ops) takes
    over the cache update + attend, the seam the paged layout plugs into;
    ``None`` is the dense path, which writes at ``pos`` (or its ring slot)
    in place.  ``cross=True`` is whisper's cross-attention: the cache's k
    and v (B, n_frames, KV, hd) are the encoder's, static and all live; no
    RoPE on q, nothing written.  Returns ((B, 1, d), the cache).

    Over a 'model' axis (serving, the dense layout): ``tp`` as in
    `attention_train` (q on the local heads, ``wo`` row-parallel,
    ``kv_sharded``: ``wk`` / ``wv`` hold local KV heads), and ``seq`` the
    axis whose ranks each hold a block of the cache's positions (the
    cache specs shard the sequence where the KV heads do not divide the
    axis): the new k / v go to the rank that owns the position (or its
    ring slot) only, and the attend reads the whole row, gathered for
    this layer (`ModelAxis.gather_positions`), so its softmax runs over
    the same keys as in one process."""
    B = x.shape[0]
    q = project(x, params["wq"], tp)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, norm_eps)
    H, hd = q.shape[2], q.shape[3]
    wo = params["wo"]
    if cross:
        k_cache, v_cache = _whole_row(cache["k"], cache["v"], seq, tp,
                                      kv_sharded, H)
        valid = torch.ones(k_cache.shape[1], dtype=torch.bool,
                           device=x.device)
        KV = k_cache.shape[2]
        out = attend_one(q.reshape(B, KV, H // KV, hd), k_cache, v_cache,
                         valid)
        out = out.reshape(B, 1, H * hd).to(x.dtype)
        return row_matmul(out, wo.reshape(H * hd, wo.shape[-1]), tp), cache
    positions = decode_positions(pos)
    tk = tp if kv_sharded else None
    k_new = project(x, params["wk"], tk)
    v_new = project(x, params["wv"], tk)
    if qk_norm:
        k_new = rmsnorm(params["k_norm"], k_new, norm_eps)
    if rope_theta > 0:
        if mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, rope_theta, mrope_sections)
            k_new = apply_mrope(k_new, mrope_positions, rope_theta,
                                mrope_sections)
        else:
            q = apply_rope(q, positions, rope_theta)
            k_new = apply_rope(k_new, positions, rope_theta)
    if cache_ops is not None:
        KV = k_new.shape[2]
        out, cache = cache_ops.kv_attend(
            cache, q.reshape(B, KV, H // KV, hd), k_new, v_new,
            window=window)
    else:
        rows = torch.arange(B, device=x.device)
        cache_len = cache["k"].shape[1] * (1 if seq is None else seq.size)
        slot = (pos.long() % cache_len if window > 0 else pos.long()) \
            .expand(B)
        write_owned(cache["k"], rows, slot, k_new[:, 0], seq)
        write_owned(cache["v"], rows, slot, v_new[:, 0], seq)
        k_cache, v_cache = _whole_row(cache["k"], cache["v"], seq, tp,
                                      kv_sharded, H)
        KV = k_cache.shape[2]
        # a ring that has wrapped is live in every slot
        valid = torch.arange(cache_len, device=x.device) <= pos
        out = attend_one(q.reshape(B, KV, H // KV, hd), k_cache, v_cache,
                         valid)
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return row_matmul(out, wo.reshape(H * hd, wo.shape[-1]), tp), cache


def _whole_row(k: torch.Tensor, v: torch.Tensor, seq, tp, kv_sharded: bool,
               h_local: int):
    """The k / v caches a decode step's local heads attend over: the
    whole row of positions (gathered over ``seq`` where the ranks hold
    blocks of it), of the KV heads those heads read (``_local_kv`` where
    the caches hold every KV head and the heads are sharded)."""
    if seq is not None:
        k, v = seq.gather_positions(k, v, dim=1)
    if tp is not None and not kv_sharded:
        k, v = _local_kv(k, v, h_local, tp)
    return k, v


# ---------------------------------------------------------------------------
# chunked prefill against the paged cache
# ---------------------------------------------------------------------------


def attention_prefill_chunk(params: dict, cache: dict, x: torch.Tensor,
                            positions: torch.Tensor, *, rope_theta: float,
                            qk_norm: bool = False, norm_eps: float = 1e-6,
                            cache_ops=None):
    """A chunk of a prompt against the paged KV cache: x (B, L, d) at
    absolute ``positions`` (L,); the prompt's earlier positions are already
    in the pages ``cache_ops`` (`repro_torch.models.cache._ChunkOps`)
    addresses.  The chunk's k/v are written into the pages first, then its
    queries attend over the linearized view, the causal mask hiding the
    future.  Returns ((B, L, d), the cache, updated in place)."""
    B, L, _ = x.shape
    q = project(x, params["wq"])
    k = project(x, params["wk"])
    v = project(x, params["wv"])
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, norm_eps)
        k = rmsnorm(params["k_norm"], k, norm_eps)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    qg = q.reshape(B, L, KV, H // KV, hd)
    out, cache = cache_ops.kv_prefill_attend(cache, qg, k, v, positions)
    out = out.reshape(B, L, H * hd).to(x.dtype)
    wo = params["wo"]
    return matmul(out, wo.reshape(H * hd, wo.shape[-1])), cache


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, lead, d: int, n_heads: int, mla_cfg,
             dtype) -> dict:
    """The reference's ``init_mla`` with a leading stacked-layer shape
    ``lead``: the query and kv down-projections to their latent ranks,
    the latents' norms, the shared rope key projection ``w_kr``, the
    per-head up-projections and ``wo``."""
    m, lead = mla_cfg, tuple(lead)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, lead + (d, m.q_lora_rank), dtype,
                           in_axis_size=d),
        "q_norm": init_rmsnorm(lead + (m.q_lora_rank,), dtype, gen.device),
        "w_uq": dense_init(gen, lead + (m.q_lora_rank, n_heads, qk), dtype,
                           in_axis_size=m.q_lora_rank),
        "w_dkv": dense_init(gen, lead + (d, m.kv_lora_rank), dtype,
                            in_axis_size=d),
        "kv_norm": init_rmsnorm(lead + (m.kv_lora_rank,), dtype,
                                gen.device),
        "w_kr": dense_init(gen, lead + (d, m.qk_rope_head_dim), dtype,
                           in_axis_size=d),
        "w_uk": dense_init(gen, lead + (m.kv_lora_rank, n_heads,
                                        m.qk_nope_head_dim), dtype,
                           in_axis_size=m.kv_lora_rank),
        "w_uv": dense_init(gen, lead + (m.kv_lora_rank, n_heads,
                                        m.v_head_dim), dtype,
                           in_axis_size=m.kv_lora_rank),
        "wo": dense_init(gen, lead + (n_heads, m.v_head_dim, d), dtype,
                         in_axis_size=n_heads * m.v_head_dim),
    }


def _mla_query(params: dict, x: torch.Tensor, positions: torch.Tensor,
               m, rope_theta: float, norm_eps: float, tp=None):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope) roped); with
    ``tp`` H is this rank's heads, the replicated latent entering
    ``w_uq``'s local heads through `ModelAxis.copy`."""
    q_lat = rmsnorm(params["q_norm"], matmul(x, params["w_dq"]), norm_eps)
    q = project(q_lat, params["w_uq"], tp)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, rope_theta)


def mla_latents(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                rope_theta: float, norm_eps: float = 1e-6):
    """What the latent cache stores per token: (ckv (B, S, kv_lora_rank),
    the normed latent; k_rope (B, S, qk_rope_head_dim), the roped key
    shared by every head)."""
    ckv = rmsnorm(params["kv_norm"], matmul(x, params["w_dkv"]), norm_eps)
    k_rope = apply_rope(matmul(x, params["w_kr"])[..., None, :], positions,
                        rope_theta)[..., 0, :]
    return ckv, k_rope


def _mla_expand(params: dict, q_nope, q_rope, ckv, k_rope, tp=None):
    """The multi-query form: keys and values expanded from the latents
    through ``w_uk`` / ``w_uv``, the rope key broadcast over the heads.
    Returns (q (B, Sq, H, 1, qk), k (B, Sk, H, qk), v (B, Sk, H, vd)).
    With ``tp`` H is this rank's heads: the replicated latents ``ckv``
    and ``k_rope`` enter them through `ModelAxis.copy`."""
    if tp is not None:
        k_rope = tp.copy(k_rope)
    k_nope = project(ckv, params["w_uk"], tp)
    v = project(ckv, params["w_uv"], tp)
    H = q_nope.shape[2]
    kr = k_rope[:, :, None, :].expand(-1, -1, H, -1).to(k_nope.dtype)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q[:, :, :, None, :], torch.cat([k_nope, kr], dim=-1), v


def _mla_out(params: dict, out: torch.Tensor, dtype=None, tp=None):
    """(B, S, H, vd) attention output -> (B, S, d) through ``wo``, cast
    to ``dtype`` first where the reference casts (the chunk path); with
    ``tp`` ``wo`` is row-parallel over the local heads."""
    B, S, H, vd = out.shape
    wo = params["wo"]
    out = out.reshape(B, S, H * vd)
    return row_matmul(out if dtype is None else out.to(dtype),
                      wo.reshape(H * vd, wo.shape[-1]), tp)


def mla_train(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
              mla_cfg, rope_theta: float, norm_eps: float = 1e-6,
              return_latents: bool = False, tp=None, q_chunk: int = 512,
              kv_chunk: int = 1024):
    """x: (B, S, d) -> (B, S, d), causal, through the plain core
    (`blocked_attention` over blocks of ``min(q_chunk, S)`` queries and
    ``min(kv_chunk, S)`` keys: the q·k head is nope + rope wide, v is
    ``v_head_dim`` wide, so no kernel of the port takes it; the reference
    too runs MLA through its plain blocked attention).  With
    ``return_latents`` also the (ckv, k_rope) the decode cache stores.
    ``tp``: ``w_uq`` / ``w_uk`` / ``w_uv`` hold this rank's heads and
    ``wo`` is row-parallel; the down-projections, the latents (those
    returned too) and their norms stay whole on every rank."""
    m = mla_cfg
    B, S, _ = x.shape
    q_nope, q_rope = _mla_query(params, x, positions, m, rope_theta,
                                norm_eps, tp)
    ckv, k_rope = mla_latents(params, x, positions, rope_theta=rope_theta,
                              norm_eps=norm_eps)
    qg, k, v = _mla_expand(params, q_nope, q_rope, ckv, k_rope, tp)
    out = blocked_attention(qg, k, v, positions, positions, causal=True,
                            window=0, q_chunk=min(q_chunk, S),
                            kv_chunk=min(kv_chunk, S), ordered=True)[
                                :, :, :, 0]
    y = _mla_out(params, out, tp=tp)
    return (y, ckv, k_rope) if return_latents else y


def init_mla_cache(batch: int, cache_len: int, mla_cfg, dtype,
                   device) -> dict:
    """Zeroed dense latent caches: ckv (batch, cache_len, kv_lora_rank)
    and k_rope (batch, cache_len, qk_rope_head_dim)."""
    return {
        "ckv": torch.zeros((batch, cache_len, mla_cfg.kv_lora_rank),
                           dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, cache_len, mla_cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_attend_one(params: dict, q_nope: torch.Tensor, q_rope: torch.Tensor,
                   ckv: torch.Tensor, k_rope: torch.Tensor,
                   valid: torch.Tensor, *, mla_cfg, out_dtype
                   ) -> torch.Tensor:
    """The absorbed-weight MLA core for one token: ``w_uk`` folded into
    the query, scores and values taken in the latent space.  q_nope (B, H,
    nope), q_rope (B, H, rope); ckv (B, C, rank), k_rope (B, C, rope);
    valid (C,) shared or (B, C) per row.  The scores and the latent values
    are accumulated in f32 (the reference's ``preferred_element_type``),
    the probabilities rounded to the cache dtype first, the latent values
    cast to ``out_dtype`` before ``w_uv``.  Shared by the dense and paged
    layouts, so the two are bitwise equal on matched inputs.  Returns (B,
    H, v_head_dim)."""
    m = mla_cfg
    q_abs = torch.einsum("bhk,rhk->bhr", *promoted(q_nope, params["w_uk"]))
    ckv32 = ckv.float()                   # widened once, read twice
    s = torch.einsum("bhr,bsr->bhs", q_abs.float(), ckv32)
    s = s + torch.einsum("bhk,bsk->bhs", q_rope.float(), k_rope.float())
    s = s * ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    mask = valid[None] if valid.dim() == 1 else valid
    s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    lat = torch.einsum("bhs,bsr->bhr", p.to(ckv.dtype).float(),
                       ckv32).to(out_dtype)
    return torch.einsum("bhr,rhk->bhk", *promoted(lat, params["w_uv"]))


def mla_decode(params: dict, cache: dict, x: torch.Tensor,
               pos: torch.Tensor, *, mla_cfg, rope_theta: float,
               norm_eps: float = 1e-6, cache_ops=None, tp=None, seq=None):
    """One-token absorbed MLA decode.  x: (B, 1, d); pos 0-d (the dense
    layout) or per row (B,) under a paged layout, whose ``cache_ops``
    takes over the latent write and view.  The dense path writes at
    ``pos`` in place.  Returns ((B, 1, d), the cache).

    Over a 'model' axis: ``tp`` as in `mla_train` (``w_uq`` / ``w_uk`` /
    ``w_uv`` the local heads, ``wo`` row-parallel), and ``seq`` the axis
    whose ranks each hold a block of the latents' positions (the cache
    specs always shard them so): the new latents go to the rank that owns
    the position only, and the local heads attend over the whole row,
    gathered for this layer (`ModelAxis.gather_positions`)."""
    m = mla_cfg
    B = x.shape[0]
    positions = decode_positions(pos)
    q_nope, q_rope = _mla_query(params, x, positions, m, rope_theta,
                                norm_eps, tp)
    ckv_t, k_rope_t = mla_latents(params, x, positions,
                                  rope_theta=rope_theta, norm_eps=norm_eps)
    ckv_t, k_rope_t = ckv_t[:, 0], k_rope_t[:, 0]
    if cache_ops is not None:
        ckv, k_rope, valid, cache = cache_ops.mla_update(cache, ckv_t,
                                                         k_rope_t)
    else:
        rows = torch.arange(B, device=x.device)
        slot = pos.long().expand(B)
        write_owned(cache["ckv"], rows, slot, ckv_t, seq)
        write_owned(cache["k_rope"], rows, slot, k_rope_t, seq)
        ckv, k_rope = cache["ckv"], cache["k_rope"]
        if seq is not None:
            ckv, k_rope = seq.gather_positions(ckv, k_rope, dim=1)
        valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    out = mla_attend_one(params, q_nope[:, 0], q_rope[:, 0], ckv, k_rope,
                         valid, mla_cfg=m, out_dtype=x.dtype)
    return _mla_out(params, out[:, None], tp=tp), cache


def mla_prefill_chunk(params: dict, cache: dict, x: torch.Tensor,
                      positions: torch.Tensor, *, mla_cfg,
                      rope_theta: float, norm_eps: float = 1e-6,
                      cache_ops=None):
    """The MLA twin of `attention_prefill_chunk`: the chunk's latents go
    into the latent pages first, then its queries attend over the
    linearized latent view expanded through ``w_uk`` / ``w_uv`` (the
    multi-query form; the absorbed form is the one-token decode's), by
    `blocked_attention` over key blocks of ``MLA_KEY_BLOCK`` on every
    device (the reference blocks by a page: a sixteenth of the launches
    at a page of 16).  The blocking is fixed and aligned to key 0, and a
    wholly masked block is an exact no-op, so a row's bits do not depend
    on where its chunk starts: a prefix hit is the cold run's.  Returns
    ((B, L, d), the cache, updated in place)."""
    m = mla_cfg
    L = x.shape[1]
    q_nope, q_rope = _mla_query(params, x, positions, m, rope_theta,
                                norm_eps)
    ckv, k_rope = mla_latents(params, x, positions, rope_theta=rope_theta,
                              norm_eps=norm_eps)
    ckv_lin, kr_lin, cache = cache_ops.mla_prefill(cache, ckv, k_rope)
    qg, k, v = _mla_expand(params, q_nope, q_rope, ckv_lin, kr_lin)
    out = blocked_attention(qg, k, v, positions,
                            torch.arange(k.shape[1], device=x.device),
                            causal=True, window=0, q_chunk=L,
                            kv_chunk=MLA_KEY_BLOCK)
    return _mla_out(params, out[:, :, :, 0], x.dtype), cache

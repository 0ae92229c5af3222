"""Every model family of the reference (the port of
``repro.models.transformer.Model``): the ``dense`` family, blocks of kind
``attention``, full causal or sliding-window, or ``mla`` (MiniCPM3's
multi-head latent attention); the ``moe`` family, ``attention`` blocks
whose FFN is the mixture-of-experts `repro_torch.models.moe`; the ``ssm``
family, blocks of kind ``mamba``; the ``hybrid`` family,
RecurrentGemma's ``recurrent`` (RG-LRU + MLP) and ``attention_local``
blocks; the ``vlm`` family (Qwen2-VL), ``attention`` blocks under
M-RoPE behind a stub vision tower: ``batch["patches"]`` (B, n_patches,
d), precomputed patch embeddings, go through ``vision_proj`` and are
prepended to the token embeddings, ``batch["mrope_positions"]`` (3, S)
gives each position its t / h / w components, and the patches carry no
next-token loss; and the ``encdec`` family (whisper), a bidirectional
encoder over stub frame embeddings ``batch["frames"]`` (B, n_frames, d)
and decoder blocks of kind ``cross`` (causal self-attention, then
cross-attention over the encoder's output, then a plain GeLU MLP), with
sinusoidal absolute positions where ``rope_theta`` is 0.  rmsnorm or
layernorm, by ``cfg.norm``.

A model is a sequence of *stages* (`stage_plan`), each a unit of one or
more block kinds repeated: one stage of one kind for the dense and ssm
families; for the hybrid, the unit ``(recurrent, recurrent,
attention_local)`` repeated, and the remainder of the depth a trailing
stage (recurrentgemma-9b: 12 units and a ``(recurrent, recurrent)``
stage).  The parameter tree is the reference's: ``stage{i}/b{j}`` holds
block j of stage i's unit, stacked over the unit's repeats on a leading
axis, and the vocabulary is padded to a multiple of 256
(``vocab_padded``).  The reference scans over the stacked units; here a
Python loop indexes them.  Functional: ``loss(params, batch)`` takes the
tree, so per-worker gradients are ``torch.autograd.grad`` of it, for
every ported family: attention through the plain core, the Mamba and
RG-LRU scans through the differentiable chunked scan
(`repro_torch.models.ssm.ssm_scan_chunked`), as the reference trains.
The MoE blocks' load-balance aux losses are summed into the loss.  The
routed `moe_ffn` (capacity factor 1.25) runs in training and the
prefill, dropless (capacity T) at decode; ``Model(cfg, moe_dense=True)``
takes the all-experts oracle `moe_ffn_dense` everywhere instead, and
chunked prefill takes it always (the layout's ``chunkable`` gate admits
only that model: routed MoE drops tokens by batch occupancy, so a chunk
boundary would change the math).

Memory, the reference's four knobs and defaults: ``remat`` (True)
rematerialises each stage unit (every block kind of a stage at one
repeat) and each encoder block in the backward pass, keeping only its
input; ``q_chunk`` / ``kv_chunk`` (512 / 1,024) block the plain
attention core (`attention.blocked_attention`); `chunked_xent` always
rematerialises each loss chunk; ``seq_parallel`` (False) keeps the
stream between units as each rank's S / M positions over a 'model'
axis.  ``remat`` and ``seq_parallel`` change no bit of the loss or the
gradients; the block sizes change only their rounding.

Tensor parallelism: ``Model(cfg).with_model_axis(axis)`` trains on one
rank's shards of the parameter tree, as the partition
rules (`repro_torch.parallel.sharding`) lay them over the mesh's 'model'
axis (``axis``, a `repro_torch.parallel.tensor.ModelAxis`): the
vocabulary-parallel embedding (`_embed`) and loss (`chunked_xent`),
attention on the local heads (`attention.attention_train`: full,
windowed, bidirectional in the encoder, and cross-attention over the
encoder output), MLA on the local heads (`attention.mla_train`), the
column- / row-parallel MLP (`layers.mlp`), the local experts (routed
`moe.dispatch` and the oracle `moe.moe_ffn_dense`), the Mamba and RG-LRU
blocks on the local channels of their inner dims (`ssm.mamba_forward`,
`rglru.rglru_forward`) and the column-parallel vision projection.  The
norms, the router and MLA's down-projections stay whole on every rank.
Every family trains so, and serves so over the dense layout: the
prefill and the decode step run the same sharded blocks, the logits are
the vocabulary's columns gathered in rank order, and each rank's cache
is its shard under the cache specs
(`repro_torch.parallel.sharding.cache_specs`): the KV heads the rank
computes, or where the KV heads do not divide the axis (and always for
MLA's latents) its block of ``cache_len / M`` positions (a windowed
kind's ring: of ``window / M`` slots), which each decode step writes on
the owning rank and gathers whole for the attend; the Mamba and RG-LRU
states of the rank's channels.  The paged seam (``cache_ops``,
``prefill_chunk``) stays one process's, as the reference's
(`_refuse_paged`).

Serving: ``prefill`` runs the prompt and returns the last position's
logits with the dense cache tree, one entry per stage and block mirroring
the parameter tree: ``{"k", "v": (R, B, cache_len, KV, hd)}`` for full
attention, a ring ``(R, B, window, KV, hd)`` holding the last positions
at slot ``pos % window`` for a windowed kind (``window`` wide whatever
``cache_len``: the reference sizes it ``min(window, cache_len)``, which
silently drops keys still inside the window once a sequence outgrows
``cache_len``; ROADMAP queue C), ``{"ckv": (R, B, cache_len, rank),
"k_rope": (R, B, cache_len, rope)}`` for mla, ``{"conv":
(R, B, K-1, E), "ssm": (R, B, E, N)}`` for mamba and ``{"conv": (R, B,
K-1, w), "h": (R, B, w)}`` for recurrent; a ``cross`` block's self k and
v as full attention's beside the encoder's ``{"xk", "xv": (R, B,
n_frames, H, hd)}``, written once by the prefill and static after;
``decode_step`` advances one
token and updates the cache tree (dense, or the one a
`repro_torch.models.cache` layout addresses) in place; ``prefill_chunk``
runs one chunk of a prompt against the paged cache from an absolute
position on, for chunked prefill and prefix-cache hits (full attention
and mla only).

Routes: the prefill's attention core is the hand-written flash-attention
kernel (`repro_torch.kernels.flash_attention`, windowed for the windowed
kinds, bidirectional for the encoder and the cross-attention) and the
Mamba scan the selective-scan kernel
(`repro_torch.kernels.ssm_scan`): their wrappers launch the CUDA kernels
on the card and run the plain versions on the CPU.  The RG-LRU scan has
no kernel: it takes the chunked scan everywhere.  ``Model(cfg,
kernels=False)`` takes the plain routes on any device, the reference the
kernels are held against on the card.  ``loss`` and ``logits`` always
take the plain routes (the kernels have no backward).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.core.types import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.cache import resolved_window, stacked
from repro_torch.models.layers import (checkpointed, dense_init,
                                       embed_init, init_layernorm, init_mlp,
                                       init_rmsnorm, layernorm, matmul, mlp,
                                       rmsnorm, sinusoidal,
                                       sinusoidal_positions)
from repro_torch.parallel.tensor import PAGED_ONE_PROCESS, UNEVEN_LIMIT

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_ATTENTION = ("attention", "attention_local", "cross")
_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
_SELF = ("k", "v", "k_scale", "v_scale")  # a cross block's self-cache


@dataclasses.dataclass(frozen=True)
class Stage:
    kinds: Tuple[str, ...]  # block kinds within one unit
    repeats: int


def stage_plan(cfg: ModelConfig) -> List[Stage]:
    """The reference's ``stage_plan``."""
    if cfg.family == "ssm":
        return [Stage(("mamba",), cfg.n_layers)]
    if cfg.family == "hybrid":
        pattern = cfg.rglru.block_pattern
        unit = tuple("recurrent" if p == "recurrent" else "attention_local"
                     for p in pattern)
        n_units, rem = divmod(cfg.n_layers, len(pattern))
        stages = [Stage(unit, n_units)]
        if rem:
            stages.append(Stage(unit[:rem], 1))
        return stages
    if cfg.family == "encdec":
        return [Stage(("cross",), cfg.n_layers)]
    return [Stage(("mla" if cfg.mla is not None else "attention",),
                  cfg.n_layers)]


def _init_norm(cfg: ModelConfig, shape, dtype, device) -> dict:
    init = init_layernorm if cfg.norm == "layernorm" else init_rmsnorm
    return init(shape, dtype, device)


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The block norm ``cfg.norm`` names, as the reference's ``_norm``."""
    if cfg.norm == "layernorm":
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


class Model:
    """Functional model wrapper over a nested-dict parameter tree."""

    def __init__(self, cfg: ModelConfig, *, remat: bool = True,
                 q_chunk: int = 512, kv_chunk: int = 1024,
                 scan_chunk: int = 256, loss_chunk: int = 2048,
                 moe_dense: bool = False, seq_parallel: bool = False,
                 kernels: bool = True):
        if cfg.family not in _FAMILIES \
                or cfg.norm not in ("rmsnorm", "layernorm") \
                or cfg.activation not in ("silu", "gelu", "relu"):
            raise ValueError(
                f"{cfg.name}: family {cfg.family!r}, norm {cfg.norm!r}, "
                f"activation {cfg.activation!r}; the reference has the "
                f"families {_FAMILIES}, rmsnorm or layernorm, silu, gelu or "
                "relu")
        self.cfg = cfg
        self.remat = bool(remat)
        self.moe_dense = bool(moe_dense)
        self.seq_parallel = bool(seq_parallel)
        self.stages = stage_plan(cfg)
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        self.loss_chunk = loss_chunk
        self.scan_chunk = scan_chunk
        self.kernels = bool(kernels)
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.param_dtype = _DTYPES[cfg.param_dtype]
        self.vocab_padded = -(-cfg.vocab_size // 256) * 256
        # the tensor-parallel context (None: the whole tree in one rank)
        # and whether the heads / KV heads shard over it
        self.tp = None
        self._heads_tp = self._kv_tp = False

    def with_model_axis(self, tp) -> "Model":
        """This model over ``tp``, the 'model' axis of a mesh: a copy that
        trains on one rank's shards (``tp.size`` 1: the model itself).
        The heads shard where the partition rules shard them (their count
        divides the axis); otherwise the attention weights stay whole and
        every rank computes every head."""
        from repro_torch.parallel.sharding import _attn_shardable
        if tp is None or tp.size == 1:
            return self
        out = copy.copy(self)
        out.tp = tp
        out._heads_tp = _attn_shardable(self.cfg.eff_n_heads, tp.size)
        out._kv_tp = _attn_shardable(self.cfg.eff_n_kv_heads, tp.size)
        return out

    @property
    def _tp_heads(self):
        """The axis the attention heads shard over (None: whole)."""
        return self.tp if self._heads_tp else None

    @property
    def _seq_tp(self):
        """The axis a KV cache's positions shard over (None: its KV heads
        shard, or one process): the cache specs cut the sequence where
        the KV heads do not divide the axis."""
        return self.tp if self.tp is not None and not self._kv_tp else None

    def _refuse_paged(self, what: str) -> None:
        if self.tp is not None:
            raise ValueError(f"{what} over a 'model' axis of {self.tp.size}: "
                             f"{PAGED_ONE_PROCESS}")

    def _check_cache_dims(self, cache_len: int) -> None:
        """Over a 'model' axis, raise where a cache dim the specs shard
        by position does not divide the axis."""
        tp = self.tp
        if tp is None:
            return
        kinds = {k for st in self.stages for k in st.kinds}
        dims = {}
        if "mla" in kinds:
            dims["the MLA latents' cache_len"] = cache_len
        if self._seq_tp is not None:
            for kind in kinds & set(_ATTENTION):
                w = resolved_window(self.cfg, kind)
                what = "ring" if w > 0 else "cache_len"
                dims[f"the {kind} cache's {what}"] = w if w > 0 \
                    else cache_len
            if "cross" in kinds:
                dims["the encoder cache's n_frames"] = \
                    self.cfg.encoder.n_frames
        bad = [f"{k} {n}" for k, n in dims.items() if n % tp.size]
        if bad:
            raise ValueError(
                f"{self.cfg.name}: {', '.join(bad)} does not divide over "
                f"the 'model' axis of {tp.size} ({UNEVEN_LIMIT})")

    # -------------------------------------------------- init

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights from ``gen``, on ``gen``'s device."""
        cfg, dt, dev = self.cfg, self.param_dtype, gen.device
        d = cfg.d_model
        params: Dict[str, Any] = {
            "embed": {"tok": embed_init(gen, (self.vocab_padded, d), dt)},
            "final_norm": _init_norm(cfg, (d,), dt, dev),
            "unembed": dense_init(gen, (d, self.vocab_padded), dt),
        }
        if cfg.vlm is not None:
            params["vision_proj"] = dense_init(gen, (d, d), dt)
        for si, stage in enumerate(self.stages):
            params[f"stage{si}"] = {
                f"b{j}": self._init_block(gen, kind, (stage.repeats,))
                for j, kind in enumerate(stage.kinds)}
        if cfg.encoder is not None:
            # the encoder's blocks: bidirectional attention, no MoE, no
            # qk norm, stacked over its depth
            enc = dataclasses.replace(cfg, moe=None, qk_norm=False)
            params["encoder"] = {
                "blocks": self._init_block(gen, "attention",
                                           (cfg.encoder.n_layers,), enc),
                "final_norm": _init_norm(cfg, (d,), dt, dev)}
        return params

    def _init_block(self, gen: torch.Generator, kind: str, lead,
                    cfg: Optional[ModelConfig] = None) -> dict:
        cfg = cfg or self.cfg
        dt, dev = self.param_dtype, gen.device
        d = cfg.d_model
        if kind == "mamba":
            return {"ln": _init_norm(cfg, lead + (d,), dt, dev),
                    "mamba": ssm_mod.init_mamba(gen, lead, d, cfg.ssm, dt)}
        p = {"ln1": _init_norm(cfg, lead + (d,), dt, dev)}
        if kind == "recurrent":
            p["rglru"] = rglru_mod.init_rglru_block(gen, lead, d, cfg.rglru,
                                                    dt)
        elif kind == "mla":
            p["attn"] = attn.init_mla(gen, lead, d, cfg.eff_n_heads, cfg.mla,
                                      dt)
        else:
            p["attn"] = attn.init_attention(gen, lead, d, cfg.eff_n_heads,
                                            cfg.eff_n_kv_heads,
                                            cfg.resolved_head_dim,
                                            cfg.qk_norm, dt)
        if kind == "cross":
            p["ln_x"] = _init_norm(cfg, lead + (d,), dt, dev)
            p["xattn"] = attn.init_cross_attention(
                gen, lead, d, cfg.eff_n_heads, cfg.resolved_head_dim, dt)
        p["ln2"] = _init_norm(cfg, lead + (d,), dt, dev)
        if cfg.moe is not None and kind == "attention":
            p["moe"] = moe_mod.init_moe(gen, lead, d, cfg.moe, cfg.mlp_gated,
                                        dt)
        else:
            p["mlp"] = init_mlp(gen, lead, d, cfg.d_ff, cfg.mlp_gated, dt)
        return p

    def _blocks(self, params, caches=None):
        """(stage, block name, kind, the block's params[, its cache]) of
        every layer in execution order: unit by unit within a stage,
        block by block within a unit.  The params and cache entries are
        views of the stacked tree, so writes land in it."""
        for si, stage in enumerate(self.stages):
            for r in range(stage.repeats):
                for j, kind in enumerate(stage.kinds):
                    name = f"b{j}"
                    p = T.map(lambda a: a[r], params[f"stage{si}"][name])
                    if caches is None:
                        yield si, name, kind, p
                    else:
                        c = {k: v[r] for k, v in caches[si][name].items()}
                        yield si, name, kind, p, c

    # -------------------------------------------------- forward

    def _embed(self, params, batch, positions=None) -> torch.Tensor:
        """Token embeddings in the compute dtype, a VLM's projected patch
        embeddings (``batch["patches"]``, both operands in the compute
        dtype) prepended, and where ``rope_theta`` is 0 the sinusoidal
        positions added: at ``positions`` (broadcastable to (B, S)), by
        default 0 .. S - 1."""
        cfg, cd = self.cfg, self.compute_dtype
        x = _lookup(params["embed"]["tok"], batch["tokens"], self.tp).to(cd)
        if cfg.vlm is not None and "patches" in batch:
            pe = batch["patches"].to(cd) @ params["vision_proj"].to(cd)
            if self.tp is not None:
                # this rank's columns, joining the replicated stream: the
                # narrow backward of `gather` is the right edge here
                pe = self.tp.gather(pe, -1)
            x = torch.cat([pe, x], dim=1)
        if cfg.rope_theta == 0.0:
            pe = sinusoidal_positions(x.shape[1], cfg.d_model, x.device) \
                if positions is None else sinusoidal(positions, cfg.d_model)
            x = x + pe.to(x.dtype)
        return x

    def _encoder_out(self, params, frames: torch.Tensor,
                     core: str) -> torch.Tensor:
        """Whisper's encoder over the stub frame embeddings (B, n_frames,
        d): sinusoidal positions, bidirectional attention blocks through
        ``core`` ("plain" or "flash"), the final norm."""
        cfg, cd = self.cfg, self.compute_dtype
        x = frames.to(cd) + sinusoidal_positions(
            frames.shape[1], cfg.d_model, frames.device).to(cd)
        positions = torch.arange(x.shape[1], device=x.device)
        chunks = self._chunks(x.shape[1])
        enc = params["encoder"]
        for r in range(T.leaves(enc["blocks"])[0].shape[0]):
            p = T.map(lambda a: a[r], enc["blocks"])

            def block(x, p=p):
                h = attn.attention_train(p["attn"], _norm(cfg, p["ln1"], x),
                                         positions, rope_theta=0.0,
                                         causal=False, core=core,
                                         tp=self._tp_heads,
                                         kv_sharded=self._kv_tp, **chunks)
                x = x + h
                return x + mlp(p["mlp"], _norm(cfg, p["ln2"], x),
                               cfg.activation, self.tp)
            # each encoder block is a remat unit of its own
            x = checkpointed(block, x, reads=T.leaves(p)) if self.remat \
                else block(x)
        return _norm(cfg, enc["final_norm"], x)

    def _chunks(self, S: int) -> dict:
        """The attention blocks of a stream of S positions, as the
        reference's ``_ctx``: ``min(q_chunk, S)`` x ``min(kv_chunk, S)``
        (the attention narrows the keys' to its own key count)."""
        return {"q_chunk": min(self.q_chunk, S),
                "kv_chunk": min(self.kv_chunk, S)}

    def _context(self, params, batch, core: str) -> dict:
        """What the blocks read besides x: a VLM's ``mrope`` positions (3,
        S), and an encoder-decoder's encoder output ``enc``."""
        cfg, ctx = self.cfg, {}
        if cfg.vlm is not None and "mrope_positions" in batch:
            ctx["mrope"] = batch["mrope_positions"]
        if cfg.encoder is not None:
            if "frames" not in batch:
                raise KeyError(f"{cfg.name}: the batch has no 'frames', "
                               "the encoder's input (B, n_frames, d)")
            ctx["enc"] = self._encoder_out(params, batch["frames"], core)
        return ctx

    def _ffn(self, p: dict, h: torch.Tensor, aux: Optional[list] = None,
             capacity_factor: float = 1.25) -> torch.Tensor:
        """The block's FFN: the gated MLP, or the MoE (`moe_ffn` at
        ``capacity_factor``, or the oracle under ``moe_dense``), its aux
        loss appended to ``aux``."""
        if "moe" not in p:
            return mlp(p["mlp"], h, self.cfg.activation, self.tp)
        if self.moe_dense:
            h, a = moe_mod.moe_ffn_dense(p["moe"], h, self.cfg.moe,
                                         self.cfg.activation, self.tp)
        else:
            h, a = moe_mod.moe_ffn(p["moe"], h, self.cfg.moe,
                                   self.cfg.activation,
                                   capacity_factor=capacity_factor,
                                   tp=self.tp)
        if aux is not None:
            aux.append(a)
        return h

    def _block(self, kind: str, p: dict, x: torch.Tensor,
               positions: torch.Tensor, cache_out: Optional[list] = None,
               aux: Optional[list] = None,
               ctx: Optional[dict] = None) -> torch.Tensor:
        """One block; with ``cache_out`` (the prefill) the block's decode
        cache entry is appended to it and the kernel routes are taken; an
        MoE block's aux loss is appended to ``aux``; ``ctx`` is
        `_context`'s, with `_backbone`'s attention blocks."""
        # bf16 + f32 promotes to f32 in torch as in jnp: with f32 weights
        # the residual stream is f32 from the first block on
        cfg, ctx = self.cfg, ctx or {}
        prefill = cache_out is not None
        core = "flash" if prefill and self.kernels else "plain"
        chunks = {k: ctx[k] for k in ("q_chunk", "kv_chunk")}
        if kind == "mamba":
            h = _norm(cfg, p["ln"], x)
            if prefill:
                h, entry = ssm_mod.mamba_prefill(p["mamba"], h, cfg.ssm,
                                                 use_kernel=self.kernels,
                                                 tp=self.tp)
                cache_out.append(entry)
            else:
                h = ssm_mod.mamba_forward(p["mamba"], h, cfg.ssm,
                                          chunk=self.scan_chunk, tp=self.tp)
            return x + h
        h = _norm(cfg, p["ln1"], x)
        if kind == "recurrent":
            if prefill:
                h, entry = rglru_mod.rglru_prefill(p["rglru"], h, cfg.rglru,
                                                   chunk=self.scan_chunk,
                                                   tp=self.tp)
                cache_out.append(entry)
            else:
                h = rglru_mod.rglru_forward(p["rglru"], h, cfg.rglru,
                                            chunk=self.scan_chunk,
                                            tp=self.tp)
        elif kind == "mla":
            h = attn.mla_train(p["attn"], h, positions, mla_cfg=cfg.mla,
                               rope_theta=cfg.rope_theta,
                               norm_eps=cfg.norm_eps, return_latents=prefill,
                               tp=self._tp_heads, **chunks)
            if prefill:
                h, ckv, k_rope = h
                cache_out.append({"ckv": ckv, "k_rope": k_rope})
        else:
            h = attn.attention_train(
                p["attn"], h, positions, rope_theta=cfg.rope_theta,
                window=resolved_window(cfg, kind), qk_norm=cfg.qk_norm,
                norm_eps=cfg.norm_eps, mrope_positions=ctx.get("mrope"),
                mrope_sections=cfg.vlm.mrope_sections if cfg.vlm else None,
                return_kv=prefill, core=core, tp=self._tp_heads,
                kv_sharded=self._kv_tp, **chunks)
            if prefill:
                h, k, v = h
                entry = {"k": k, "v": v}
        x = x + h
        if kind == "cross":
            # the replicated encoder output enters the local heads'
            # columns through `ModelAxis.copy` (`layers.matmul`)
            enc, tk = ctx["enc"], self.tp if self._kv_tp else None
            xk = attn.project(enc, p["xattn"]["wk"], tk)
            xv = attn.project(enc, p["xattn"]["wv"], tk)
            h = attn.attention_train(p["xattn"], _norm(cfg, p["ln_x"], x),
                                     positions, rope_theta=0.0,
                                     causal=False, kv_override=(xk, xv),
                                     core=core, tp=self._tp_heads, **chunks)
            x = x + h
            if prefill:
                entry.update(xk=xk, xv=xv)
        if prefill and kind in _ATTENTION:
            cache_out.append(entry)
        h = _norm(cfg, p["ln2"], x)
        return x + self._ffn(p, h, aux)

    def _backbone(self, params, x: torch.Tensor,
                  entries: Optional[list] = None, aux: Optional[list] = None,
                  ctx: Optional[dict] = None) -> torch.Tensor:
        """All blocks over x; with ``entries`` (the prefill) each block's
        cache entry is appended to ``entries[stage][block]``, and each MoE
        block's aux loss to ``aux``; ``ctx`` is `_context`'s.

        Outside the prefill the blocks run unit by unit (`_unit`: every
        block kind of a stage at one repeat, the reference's scan body),
        each a remat unit under ``remat``; under ``seq_parallel`` over a
        'model' axis that S divides, the stream between units is this
        rank's S / M rows (the reference's ``_seq_constrain``), gathered
        whole after the last unit."""
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        ctx = {**(ctx or {}), **self._chunks(S)}
        if entries is not None:
            for si, name, kind, p in self._blocks(params):
                x = self._block(kind, p, x, positions, entries[si][name],
                                aux, ctx)
            return x
        seq = self.tp if self.seq_parallel and self.tp is not None \
            and S % self.tp.size == 0 else None
        if seq is not None:
            x = seq.seq_cut(x)
        for si, stage in enumerate(self.stages):
            for r in range(stage.repeats):
                unit = [(kind, T.map(lambda a: a[r],
                                     params[f"stage{si}"][f"b{j}"]))
                        for j, kind in enumerate(stage.kinds)]
                x, *unit_aux = self._unit(unit, x, positions, ctx, seq)
                if aux is not None:
                    aux.extend(unit_aux)
        return x if seq is None else seq.seq_gather(x)

    def _unit(self, unit, x: torch.Tensor, positions: torch.Tensor,
              ctx: dict, seq) -> tuple:
        """One remat unit: the blocks ``unit`` ((kind, params) in order)
        over x; returns (x, each MoE block's aux loss).  The aux losses
        leave the unit as outputs, so the recompute in the backward pass
        appends nothing.  Under ``remat`` only the unit's input is kept
        for the backward pass (`layers.checkpointed`), which runs the
        unit again, its 'model' collectives included, in the same order
        on every rank.  With ``seq`` x is this rank's rows: gathered
        whole inside the unit, the output cut back to the rank's rows."""
        def body(x):
            if seq is not None:
                x = seq.seq_gather(x)
            aux: list = []
            for kind, p in unit:
                x = self._block(kind, p, x, positions, None, aux, ctx)
            return (x if seq is None else seq.seq_cut(x), *aux)
        if not self.remat:
            return body(x)
        return checkpointed(body, x, reads=[t for _, p in unit
                                            for t in T.leaves(p)])

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Post-final-norm (..., d) -> f32 logits, the padded vocabulary's
        columns masked to -1e30; over a 'model' axis this rank's vocab
        columns, gathered in rank order."""
        logits = matmul(x, params["unembed"].to(x.dtype), self.tp).float()
        if self.tp is not None:
            logits = self.tp.gather(logits, -1)
        return self._mask_pad_logits(logits)

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        if self.vocab_padded == self.cfg.vocab_size:
            return logits
        pad = torch.arange(self.vocab_padded, device=logits.device) \
            >= self.cfg.vocab_size
        return logits.masked_fill(pad, -1e30)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy over labels >= 0 (a VLM's patch
        positions masked), plus the MoE blocks' aux losses summed in f32
        in block order."""
        aux: list = []
        x = self._backbone(params, self._embed(params, batch), aux=aux,
                           ctx=self._context(params, batch, "plain"))
        x = _norm(self.cfg, params["final_norm"], x)
        labels = batch["labels"]
        if self.cfg.vlm is not None and "patches" in batch:
            # the patch positions carry no next-token loss
            pads = labels.new_full(batch["patches"].shape[:2], -1)
            labels = torch.cat([pads, labels], dim=1)
        ce = chunked_xent(x, params["unembed"], labels, self.loss_chunk,
                          self.tp)
        if not aux:
            return ce
        total = torch.zeros((), dtype=torch.float32, device=ce.device)
        for a in aux:
            total = total + a
        return ce + total.to(ce.dtype)

    def logits(self, params, batch) -> torch.Tensor:
        """Full-sequence f32 logits (B, S, vocab_padded) through the plain
        routes (small-scale use: tests, examples); a VLM's S counts its
        patches."""
        x = self._backbone(params, self._embed(params, batch),
                           ctx=self._context(params, batch, "plain"))
        x = _norm(self.cfg, params["final_norm"], x)
        return self._logits(params, x)

    # -------------------------------------------------- prefill / decode

    def init_block_cache(self, kind: str, batch: int, cache_len: int,
                         dtype, device) -> Dict[str, torch.Tensor]:
        """One block's zeroed dense cache: k and v (batch, cache_len, KV,
        hd), a ring (batch, window, KV, hd) for a windowed kind, the latent
        caches (batch, cache_len, ...) for mla, or the Mamba / RG-LRU
        state (batch, ...); a cross block adds the encoder's xk and xv
        (batch, n_frames, H, hd)."""
        cfg = self.cfg
        if kind == "mamba":
            return ssm_mod.init_mamba_state(batch, cfg.d_model, cfg.ssm,
                                            dtype, device)
        if kind == "recurrent":
            return rglru_mod.init_rglru_state(batch, cfg.d_model, cfg.rglru,
                                              dtype, device)
        if kind == "mla":
            return attn.init_mla_cache(batch, cache_len, cfg.mla, dtype,
                                       device)
        window = resolved_window(cfg, kind)
        width = window if window > 0 else cache_len
        c = attn.init_kv_cache(batch, width, cfg.eff_n_kv_heads,
                               cfg.resolved_head_dim, dtype, device)
        if kind == "cross":
            enc = attn.init_kv_cache(batch, cfg.encoder.n_frames,
                                     cfg.eff_n_heads, cfg.resolved_head_dim,
                                     dtype, device)
            c.update(xk=enc["k"], xv=enc["v"])
        return c

    def init_cache(self, batch: int, cache_len: int, dtype=None, *,
                   device) -> list:
        """Zeroed dense caches in the reference's tree: per stage, per
        block of its unit, the block's cache stacked over the repeats."""
        dtype = dtype or self.compute_dtype
        return [{f"b{j}": stacked(self.init_block_cache(
            kind, batch, cache_len, dtype, device), stage.repeats)
            for j, kind in enumerate(stage.kinds)} for stage in self.stages]

    def prefill(self, params, batch, cache_len: int):
        """Forward over the prompt (B, S) (a VLM's S counts its patches,
        which come first); returns ((B, vocab_padded) f32 logits of the
        last position, the dense cache tree: full attention's with S of
        its ``cache_len`` positions filled, a windowed kind's ring of the
        last ``window`` positions, or the Mamba / RG-LRU state after the
        prompt, whose size does not depend on ``cache_len``; a cross
        block's also holds the encoder's xk / xv).  The encoder and every
        attention core take the flash-attention kernel on the kernel
        route.

        Over a 'model' axis each rank returns its shard of that tree
        under the cache specs (the module's docstring); a dim they cut by
        position must divide the axis."""
        self._check_cache_dims(cache_len)
        entries = [{f"b{j}": [] for j in range(len(st.kinds))}
                   for st in self.stages]
        core = "flash" if self.kernels else "plain"
        x = self._backbone(params, self._embed(params, batch), entries,
                           ctx=self._context(params, batch, core))
        x = _norm(self.cfg, params["final_norm"], x[:, -1])
        caches = []
        for stage, unit in zip(self.stages, entries):
            built = {}
            for j, kind in enumerate(stage.kinds):
                e = unit[f"b{j}"]
                if kind in _ATTENTION:
                    c = _kv_cache_from_seq(e, cache_len,
                                           resolved_window(self.cfg, kind))
                    if kind == "cross":
                        c.update({n: torch.stack([x[n] for x in e])
                                  for n in ("xk", "xv")})
                    built[f"b{j}"] = _positions(c, self._seq_tp)
                elif kind == "mla":
                    built[f"b{j}"] = _positions(
                        _mla_cache_from_seq(e, cache_len), self.tp)
                else:
                    built[f"b{j}"] = _stack(e)
            caches.append(built)
        return self._logits(params, x), caches

    def decode_step(self, params, caches, batch, cache_ops=None):
        """batch: ``tokens`` (B, 1) and ``pos`` (a 0-d int tensor, or a
        per-row (B,) vector under a paged layout), on the params' device,
        and a VLM's ``mrope_positions`` ((3, 1) or (3, B, 1)).  Returns
        ((B, vocab_padded) f32 logits, ``caches`` updated in place).
        ``cache_ops`` (a `repro_torch.models.cache` layout's step ops)
        reroutes the attention cache update + attend: the paged-KV and
        slot-ring seam, one process's only (`_refuse_paged`).  Over a
        'model' axis ``caches`` is this rank's shard (`prefill`)."""
        if cache_ops is not None:
            self._refuse_paged("a paged decode step (cache_ops)")
        pos = batch["pos"]
        x = self._embed(params, batch, pos.reshape(-1, 1))
        mrope = batch.get("mrope_positions") if self.cfg.vlm else None
        for _, _, kind, p, c in self._blocks(params, caches):
            x = self._decode_block(kind, p, c, x, pos, cache_ops, mrope)
        x = _norm(self.cfg, params["final_norm"], x[:, 0])
        return self._logits(params, x), caches

    def prefill_chunk(self, params, caches, batch, *, positions,
                      cache_ops):
        """One chunk of a prompt against a paged cache
        (`repro_torch.models.cache.PagedLayout.prefill_resume`):
        ``tokens`` (B, L) at absolute ``positions`` (L,), the earlier
        positions already in the pages ``cache_ops`` addresses.  Returns
        ((B, vocab_padded) f32 logits at ``batch["last"]`` (B,), the
        chunk's last real position (its tail may be padding), ``caches``
        updated in place).  Full-attention and mla blocks only, the MoE
        FFN through the oracle: the layout's ``chunkable`` gate refuses
        the rest before dispatch."""
        self._refuse_paged("chunked prefill")
        kinds = {k for st in self.stages for k in st.kinds}
        if not kinds <= {"attention", "mla"} \
                or (self.cfg.moe is not None and not self.moe_dense):
            raise ValueError(f"chunked prefill over {sorted(kinds)} "
                             "blocks (routed MoE included): the layout's "
                             "chunkable gate should have refused")
        x = self._embed(params, batch, positions)
        for _, _, kind, p, c in self._blocks(params, caches):
            x = self._prefill_chunk_block(kind, p, c, x, positions,
                                          cache_ops)
        rows = torch.arange(x.shape[0], device=x.device)
        x = _norm(self.cfg, params["final_norm"], x[rows, batch["last"]])
        return self._logits(params, x), caches

    def _prefill_chunk_block(self, kind: str, p: dict, cache: dict,
                             x: torch.Tensor, positions: torch.Tensor,
                             cache_ops) -> torch.Tensor:
        cfg = self.cfg
        h = _norm(cfg, p["ln1"], x)
        if kind == "mla":
            h, _ = attn.mla_prefill_chunk(p["attn"], cache, h, positions,
                                          mla_cfg=cfg.mla,
                                          rope_theta=cfg.rope_theta,
                                          norm_eps=cfg.norm_eps,
                                          cache_ops=cache_ops)
        else:
            h, _ = attn.attention_prefill_chunk(p["attn"], cache, h,
                                                positions,
                                                rope_theta=cfg.rope_theta,
                                                qk_norm=cfg.qk_norm,
                                                norm_eps=cfg.norm_eps,
                                                cache_ops=cache_ops)
        x = x + h
        h = _norm(cfg, p["ln2"], x)
        return x + self._ffn(p, h)

    def _decode_block(self, kind: str, p: dict, cache: dict,
                      x: torch.Tensor, pos: torch.Tensor, cache_ops,
                      mrope: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, tp = self.cfg, self.tp
        if kind == "mamba":   # slot-indexed state: no cache_ops seam
            h = _norm(cfg, p["ln"], x)
            h, _ = ssm_mod.mamba_decode(p["mamba"], cache, h, cfg.ssm, tp=tp)
            return x + h
        h = _norm(cfg, p["ln1"], x)
        if kind == "recurrent":
            h, _ = rglru_mod.rglru_decode(p["rglru"], cache, h, cfg.rglru,
                                          tp=tp)
        elif kind == "mla":
            h, _ = attn.mla_decode(p["attn"], cache, h, pos, mla_cfg=cfg.mla,
                                   rope_theta=cfg.rope_theta,
                                   norm_eps=cfg.norm_eps, cache_ops=cache_ops,
                                   tp=self._tp_heads, seq=tp)
        else:
            # a cross block's self part: its k / v (and their scales)
            self_c = {n: cache[n] for n in _SELF if n in cache}
            h, _ = attn.attention_decode(
                p["attn"], self_c, h, pos, rope_theta=cfg.rope_theta,
                window=resolved_window(cfg, kind), qk_norm=cfg.qk_norm,
                norm_eps=cfg.norm_eps, mrope_positions=mrope,
                mrope_sections=cfg.vlm.mrope_sections if cfg.vlm else None,
                cache_ops=cache_ops, tp=self._tp_heads,
                kv_sharded=self._kv_tp, seq=self._seq_tp)
        x = x + h
        if kind == "cross":
            h, _ = attn.attention_decode(
                p["xattn"], {"k": cache["xk"], "v": cache["xv"]},
                _norm(cfg, p["ln_x"], x), pos, rope_theta=0.0, cross=True,
                tp=self._tp_heads, kv_sharded=self._kv_tp, seq=self._seq_tp)
            x = x + h
        h = _norm(cfg, p["ln2"], x)
        # dropless at decode: a dropped token would corrupt generation
        return x + self._ffn(p, h, capacity_factor=-1.0)


def _kv_cache_from_seq(entries, cache_len: int,
                       window: int = 0) -> Dict[str, torch.Tensor]:
    """Each layer's {"k", "v"} of the prompt, (B, S, KV, hd), laid out as
    the decode cache expects and stacked: {"k", "v"}: (R, B, cache_len,
    KV, hd), zero-padded; for ``window > 0`` the ring (R, B, window, KV,
    hd) holding the last ``window`` positions at slot ``pos % window``
    (the reference's ``_kv_cache_from_seq``, whose ring is ``min(window,
    cache_len)`` wide: the same while the sequence fits ``cache_len``).  The reference
    recomputes k and v from the normed block input; here they are the
    attention's own, the same values."""
    S = entries[0]["k"].shape[1]
    if window <= 0 and S > cache_len:
        raise ValueError(f"a prompt of {S} positions does not fit a "
                         f"cache of {cache_len}")
    if window > 0:
        w = window
        slots = torch.arange(max(S - w, 0), S) % w
        out = {}
        for name in ("k", "v"):
            seq = torch.stack([e[name] for e in entries])[:, :, -w:]
            ring = seq.new_zeros(seq.shape[:2] + (w,) + seq.shape[3:])
            ring[:, :, slots.to(seq.device)] = seq
            out[name] = ring
        return out
    pad = (0, 0, 0, 0, 0, cache_len - S)
    return {name: torch.stack([F.pad(e[name], pad) for e in entries])
            for name in ("k", "v")}


def _mla_cache_from_seq(entries, cache_len: int) -> Dict[str, torch.Tensor]:
    """Each layer's latents of the prompt, {"ckv", "k_rope"}: (B, S, ...),
    zero-padded to ``cache_len`` and stacked (R, B, cache_len, ...), the
    reference's ``_mla_cache_from_seq`` (which recomputes them from the
    normed block input; here they are the attention's own, the same
    values)."""
    S = entries[0]["ckv"].shape[1]
    return {name: torch.stack([F.pad(e[name], (0, 0, 0, cache_len - S))
                               for e in entries])
            for name in ("ckv", "k_rope")}


def _positions(cache: Dict[str, torch.Tensor],
               tp) -> Dict[str, torch.Tensor]:
    """A stacked cache entry (R, B, positions, ...) cut to this rank's
    block of positions over ``tp`` (the entry itself without one)."""
    if tp is None:
        return cache
    out = {}
    for name, x in cache.items():
        n = x.shape[2] // tp.size
        lo = tp.shard_start(n)
        out[name] = x[:, :, lo:lo + n].clone()
    return out


def _stack(entries) -> Dict[str, torch.Tensor]:
    """Per-layer state entries stacked on a leading layer axis (at the
    layers' promoted dtype: under bf16 compute the first layer's conv
    state is bf16, the rest f32)."""
    return {name: torch.stack([e[name] for e in entries])
            for name in entries[0]}


def _lookup(tok: torch.Tensor, ids: torch.Tensor, tp) -> torch.Tensor:
    """Embedding rows of ``ids``.  With ``tp`` the table is this rank's
    block of the vocabulary: ids outside it read zeros, and the sum over
    the axis (exactly one rank holds each id) is the whole lookup."""
    if tp is None:
        return tok[ids]
    lo = tp.shard_start(tok.shape[0])
    local = ids - lo
    mine = (local >= 0) & (local < tok.shape[0])
    rows = tok[torch.where(mine, local, torch.zeros_like(local))]
    return tp.reduce(torch.where(mine[..., None], rows,
                                 torch.zeros_like(rows)))


def chunked_xent(x: torch.Tensor, unembed: torch.Tensor,
                 labels: torch.Tensor, chunk: int, tp=None) -> torch.Tensor:
    """x: (B, S, d) post-final-norm; unembed: (d, V_padded); labels (B, S),
    -1 = masked.  Logits come one sequence chunk at a time, in f32, and
    the logsumexp runs over all padded columns, as the reference's does.
    Each chunk's body is rematerialised in the backward pass, as the
    reference's ``@jax.checkpoint`` body is (`layers.checkpointed`): only
    one chunk's (B, chunk, V) logits are alive at a time, forward and
    backward, and over 'model' the recompute issues the chunk's
    collectives again.

    With ``tp`` ``unembed`` holds this rank's block of the padded
    vocabulary's columns: the logsumexp takes the maximum over the axis
    and the sum of the shards' exponentials, and the label's logit comes
    from the rank that holds its column (`_vocab_parallel_terms`)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(xc, lc):
        logits = matmul(xc, unembed.to(xc.dtype), tp).float()
        if tp is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lc.clamp_min(0).long()[..., None])[
                ..., 0]
        else:
            logz, gold = _vocab_parallel_terms(logits, lc, tp)
        mask = (lc >= 0).float()
        return ((logz - gold) * mask).sum(), mask.sum()

    for s0 in range(0, S, chunk):
        part, n = checkpointed(body, x[:, s0:s0 + chunk],
                               labels[:, s0:s0 + chunk], reads=(unembed,))
        tot = tot + part
        cnt = cnt + n
    return tot / cnt.clamp_min(1.0)


def _vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor, tp):
    """(logsumexp, the label's logit) over the whole padded vocabulary of
    this rank's column block ``logits`` (B, c, V / M) f32: the maximum
    over the axis (held fixed, as the softmax's gradient allows), then one
    sum over the axis of each shard's exponential sum and of the label's
    logit, which only its owner contributes."""
    m = tp.max(logits.amax(dim=-1))
    lo = tp.shard_start(logits.shape[-1])
    lab = labels.clamp_min(0).long() - lo
    mine = (lab >= 0) & (lab < logits.shape[-1])
    own = logits.gather(-1, torch.where(mine, lab, torch.zeros_like(lab))[
        ..., None])[..., 0]
    own = torch.where(mine, own, torch.zeros_like(own))
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    both = tp.reduce(torch.stack([se, own]))
    return m + torch.log(both[0]), both[1]

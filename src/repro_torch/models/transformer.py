"""The decoder-only models (the port of ``repro.models.transformer.Model``
for the ``dense`` family, blocks of kind ``attention``, and the ``ssm``
family, blocks of kind ``mamba``).

The parameter tree is the reference's: the layers of the one stage are
stacked under ``stage0`` with a leading layer axis, and the vocabulary
is padded to a multiple of 256 (``vocab_padded``; 152,064 for
qwen3-0.6b, 65,024 for falcon-mamba-7b).  The reference scans over the
stacked layers; here a Python loop indexes them.  Functional:
``loss(params, batch)`` takes the tree, so per-worker gradients are
``torch.autograd.grad`` of it (dense family only: the ssm family's scan
kernel has no backward yet).

Serving: ``prefill`` runs the prompt and returns the last position's
logits with the dense cache tree, ``[{"b0": {"k": (L, B, cache_len, KV,
hd), "v": ...}}]`` for attention or ``[{"b0": {"conv": (L, B, K-1, E),
"ssm": (L, B, E, N)}}]`` for mamba; ``decode_step`` advances one token
and updates the cache tree (dense, or the one a
`repro_torch.models.cache` layout addresses) in place.

Routes: the prefill's attention core is the hand-written flash-attention
kernel (`repro_torch.kernels.flash_attention`) and the Mamba scan the
selective-scan kernel (`repro_torch.kernels.ssm_scan`): their wrappers
launch the CUDA kernels on the card and run the plain versions on the
CPU.  ``Model(cfg, kernels=False)`` takes the plain routes on any device,
the reference the kernels are held against on the card.  ``loss`` always
takes the plain attention (the kernel has no backward).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.core.types import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, embed_init, init_mlp,
                                       init_rmsnorm, matmul, mlp, rmsnorm)

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Model:
    """Functional model wrapper over a nested-dict parameter tree."""

    def __init__(self, cfg: ModelConfig, *, loss_chunk: int = 2048,
                 kernels: bool = True):
        dense = cfg.family == "dense" and cfg.moe is None \
            and cfg.mla is None and not cfg.sliding_window \
            and cfg.mlp_gated and cfg.activation == "silu"
        ssm = cfg.family == "ssm" and cfg.ssm is not None
        if not (dense or ssm) or cfg.norm != "rmsnorm":
            raise NotImplementedError(
                f"{cfg.name}: only the dense (full-causal, SiLU-gated) and "
                "ssm families with rmsnorm are ported (ROADMAP queue A6)")
        self.cfg = cfg
        self.kind = "mamba" if ssm else "attention"
        self.loss_chunk = loss_chunk
        self.kernels = bool(kernels)
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.param_dtype = _DTYPES[cfg.param_dtype]
        self.vocab_padded = -(-cfg.vocab_size // 256) * 256

    # -------------------------------------------------- init

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights from ``gen``, on ``gen``'s device."""
        cfg, dt, dev = self.cfg, self.param_dtype, gen.device
        d, L = cfg.d_model, (cfg.n_layers,)
        params: Dict[str, Any] = {
            "embed": {"tok": embed_init(gen, (self.vocab_padded, d), dt)},
            "final_norm": init_rmsnorm((d,), dt, dev),
            "unembed": dense_init(gen, (d, self.vocab_padded), dt),
        }
        if self.kind == "mamba":
            params["stage0"] = {"b0": {
                "ln": init_rmsnorm(L + (d,), dt, dev),
                "mamba": ssm_mod.init_mamba(gen, L, d, cfg.ssm, dt),
            }}
            return params
        params["stage0"] = {"b0": {
            "ln1": init_rmsnorm(L + (d,), dt, dev),
            "attn": attn.init_attention(gen, L, d, cfg.eff_n_heads,
                                        cfg.eff_n_kv_heads,
                                        cfg.resolved_head_dim, cfg.qk_norm,
                                        dt),
            "ln2": init_rmsnorm(L + (d,), dt, dev),
            "mlp": init_mlp(gen, L, d, cfg.d_ff, dt),
        }}
        return params

    # -------------------------------------------------- forward

    def _embed(self, params, batch) -> torch.Tensor:
        return params["embed"]["tok"][batch["tokens"]].to(self.compute_dtype)

    def _block(self, p: dict, x: torch.Tensor, positions: torch.Tensor,
               cache_out: Optional[list] = None) -> torch.Tensor:
        """One block; with ``cache_out`` (the prefill) the block's decode
        cache entry is appended to it and the kernel routes are taken."""
        # bf16 + f32 promotes to f32 in torch as in jnp: with f32 weights
        # the residual stream is f32 from the first block on
        cfg = self.cfg
        prefill = cache_out is not None
        if self.kind == "mamba":
            h = rmsnorm(p["ln"], x, cfg.norm_eps)
            if prefill:
                h, entry = ssm_mod.mamba_prefill(p["mamba"], h, cfg.ssm,
                                                 use_kernel=self.kernels)
                cache_out.append(entry)
            else:
                h = ssm_mod.mamba_forward(p["mamba"], h, cfg.ssm,
                                          use_kernel=self.kernels)
            return x + h
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        h = attn.attention_train(p["attn"], h, positions,
                                 rope_theta=cfg.rope_theta,
                                 qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
                                 return_kv=prefill,
                                 core="flash" if prefill and self.kernels
                                 else "plain")
        if prefill:
            h, k, v = h
            cache_out.append({"k": k, "v": v})
        x = x + h
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + mlp(p["mlp"], h)

    def _backbone(self, params, x: torch.Tensor,
                  cache_out: Optional[list] = None) -> torch.Tensor:
        positions = torch.arange(x.shape[1], device=x.device)
        stage = params["stage0"]["b0"]
        for layer in range(self.cfg.n_layers):
            x = self._block(T.map(lambda a: a[layer], stage), x, positions,
                            cache_out)
        return x

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Post-final-norm (..., d) -> f32 logits, the padded vocabulary's
        columns masked to -1e30."""
        logits = matmul(x, params["unembed"].to(x.dtype)).float()
        return self._mask_pad_logits(logits)

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        if self.vocab_padded == self.cfg.vocab_size:
            return logits
        pad = torch.arange(self.vocab_padded, device=logits.device) \
            >= self.cfg.vocab_size
        return logits.masked_fill(pad, -1e30)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy over labels >= 0."""
        if self.kind == "mamba":
            raise NotImplementedError(
                f"{self.cfg.name}: training the ssm family is not ported: "
                "the selective-scan kernel has no backward yet (ROADMAP "
                "A6, 'Left out of slice 4')")
        x = self._backbone(params, self._embed(params, batch))
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return chunked_xent(x, params["unembed"], batch["labels"],
                            self.loss_chunk)

    # -------------------------------------------------- prefill / decode

    def init_cache(self, batch: int, cache_len: int, dtype=None, *,
                   device) -> list:
        """Zeroed dense caches per stage unit, the reference's tree: one
        (L, batch, cache_len, KV, hd) k and v, or the mamba state (conv
        (L, batch, K-1, E) in ``dtype``, ssm (L, batch, E, N) f32)."""
        cfg = self.cfg
        dtype = dtype or self.compute_dtype
        if self.kind == "mamba":
            c = ssm_mod.init_mamba_state(batch, cfg.d_model, cfg.ssm, dtype,
                                         device)
        else:
            c = attn.init_kv_cache(batch, cache_len, cfg.eff_n_kv_heads,
                                   cfg.resolved_head_dim, dtype, device)
        return [{"b0": {name: t.unsqueeze(0).repeat(
            (cfg.n_layers,) + (1,) * t.dim()) for name, t in c.items()}}]

    def prefill(self, params, batch, cache_len: int):
        """Forward over the prompt (B, S); returns ((B, vocab_padded) f32
        logits of the last position, the dense cache tree: attention's
        with S of its ``cache_len`` positions filled, or the mamba state
        after the prompt, whose size does not depend on ``cache_len``)."""
        entries: list = []
        x = self._backbone(params, self._embed(params, batch), entries)
        x = rmsnorm(params["final_norm"], x[:, -1], self.cfg.norm_eps)
        if self.kind == "mamba":
            cache = _stack(entries)
        else:
            cache = _kv_cache_from_seq(entries, cache_len)
        return self._logits(params, x), [{"b0": cache}]

    def decode_step(self, params, caches, batch, cache_ops=None):
        """batch: ``tokens`` (B, 1) and ``pos`` (a 0-d int tensor, or a
        per-row (B,) vector under a paged layout), on the params' device.
        Returns ((B, vocab_padded) f32 logits, ``caches`` updated in
        place).  ``cache_ops`` (a `repro_torch.models.cache` layout's step
        ops) reroutes the cache update + attend: the paged-KV seam."""
        x = self._embed(params, batch)
        stage, cache = params["stage0"]["b0"], caches[0]["b0"]
        for layer in range(self.cfg.n_layers):
            x = self._decode_block(T.map(lambda a: a[layer], stage),
                                   {k: v[layer] for k, v in cache.items()},
                                   x, batch["pos"], cache_ops)
        x = rmsnorm(params["final_norm"], x[:, 0], self.cfg.norm_eps)
        return self._logits(params, x), caches

    def _decode_block(self, p: dict, cache: dict, x: torch.Tensor,
                      pos: torch.Tensor, cache_ops) -> torch.Tensor:
        cfg = self.cfg
        if self.kind == "mamba":   # slot-indexed state: no cache_ops seam
            h = rmsnorm(p["ln"], x, cfg.norm_eps)
            h, _ = ssm_mod.mamba_decode(p["mamba"], cache, h, cfg.ssm)
            return x + h
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        h, _ = attn.attention_decode(p["attn"], cache, h, pos,
                                     rope_theta=cfg.rope_theta,
                                     qk_norm=cfg.qk_norm,
                                     norm_eps=cfg.norm_eps,
                                     cache_ops=cache_ops)
        x = x + h
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + mlp(p["mlp"], h)


def _kv_cache_from_seq(entries, cache_len: int) -> Dict[str, torch.Tensor]:
    """Each layer's {"k", "v"} of the prompt, (B, S, KV, hd), zero-padded
    to ``cache_len`` positions and stacked: {"k", "v"}: (L, B, cache_len,
    KV, hd).  The reference recomputes them from the normed block input;
    here they are the attention's own k and v, the same values."""
    S = entries[0]["k"].shape[1]
    pad = (0, 0, 0, 0, 0, cache_len - S)
    return {name: torch.stack([F.pad(e[name], pad) for e in entries])
            for name in ("k", "v")}


def _stack(entries) -> Dict[str, torch.Tensor]:
    """Per-layer state entries stacked on a leading layer axis (at the
    layers' promoted dtype: under bf16 compute the first layer's conv
    state is bf16, the rest f32)."""
    return {name: torch.stack([e[name] for e in entries])
            for name in entries[0]}


def chunked_xent(x: torch.Tensor, unembed: torch.Tensor,
                 labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """x: (B, S, d) post-final-norm; unembed: (d, V_padded); labels (B, S),
    -1 = masked.  Logits come one sequence chunk at a time, in f32, and
    the logsumexp runs over all padded columns, as the reference's does.
    (The reference also rematerialises each chunk in the backward pass;
    here a chunk's logits stay alive until the backward pass.)"""
    S = x.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        xc, lc = x[:, s0:s0 + chunk], labels[:, s0:s0 + chunk]
        logits = matmul(xc, unembed.to(xc.dtype)).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc.clamp_min(0).long()[..., None])[..., 0]
        mask = (lc >= 0).float()
        tot = tot + ((logz - gold) * mask).sum()
        cnt = cnt + mask.sum()
    return tot / cnt.clamp_min(1.0)

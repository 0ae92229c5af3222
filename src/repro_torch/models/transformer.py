"""The dense decoder-only transformer (the port of
``repro.models.transformer.Model`` for the ``dense`` family).

The parameter tree is the reference's: the layers of the one stage are
stacked under ``stage0`` with a leading layer axis, and the vocabulary
is padded to a multiple of 256 (``vocab_padded``; 152,064 for
qwen3-0.6b).  The reference scans over the stacked layers; here a Python
loop indexes them.  Functional: ``loss(params, batch)`` takes the tree,
so per-worker gradients are ``torch.autograd.grad`` of it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import tree as T
from repro_torch.core.types import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, init_mlp,
                                       init_rmsnorm, matmul, mlp, rmsnorm)

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Model:
    """Functional model wrapper over a nested-dict parameter tree."""

    def __init__(self, cfg: ModelConfig, *, loss_chunk: int = 2048):
        if cfg.family != "dense" or cfg.moe is not None \
                or cfg.mla is not None or cfg.sliding_window \
                or cfg.norm != "rmsnorm" or not cfg.mlp_gated \
                or cfg.activation != "silu":
            raise NotImplementedError(
                f"{cfg.name}: only the dense, full-causal, rmsnorm, "
                "SiLU-gated family is ported (ROADMAP queue A6)")
        self.cfg = cfg
        self.loss_chunk = loss_chunk
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

    def _block(self, p: dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        # bf16 + f32 promotes to f32 in torch as in jnp: with f32 weights
        # the residual stream is f32 from the first block on
        cfg = self.cfg
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + attn.attention_train(p["attn"], h, positions,
                                     rope_theta=cfg.rope_theta,
                                     qk_norm=cfg.qk_norm,
                                     norm_eps=cfg.norm_eps)
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + mlp(p["mlp"], h)

    def _backbone(self, params, x: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(x.shape[1], device=x.device)
        stage = params["stage0"]["b0"]
        for layer in range(self.cfg.n_layers):
            x = self._block(T.map(lambda a: a[layer], stage), x, positions)
        return x

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy over labels >= 0."""
        x = self._backbone(params, self._embed(params, batch))
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return chunked_xent(x, params["unembed"], batch["labels"],
                            self.loss_chunk)


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

"""Mixture-of-Experts FFN (the port of ``repro.models.moe``).

Dispatch gathers token vectors into a fixed per-expert capacity
(Switch-style token dropping, with the load-balance aux loss):

  1. `route`: the f32 router, softmax, top-k expert ids and gates per
     token, the gates renormalized (floor 1e-9);
  2. `queue_positions`: each (token, k) pair's place in its expert's
     queue, a cumulative sum over the (T·K, E) one-hot assignment;
  3. `dispatch`: token indices scattered into an (E·C + 1) index buffer
     whose last entry is the sentinel of the dropped pairs, then the token
     vectors gathered into an (E, C, d) buffer, the per-expert products
     (``bmm``, plain large products, as the reference computes them
     outside any kernel), and a per-token gather of its K slots weighted
     by the kept gates.

`moe_ffn` runs the three; `moe_ffn_dense` evaluates every expert and
masks by the gates, the oracle.  The top-k is tie-stable as jax's
``lax.top_k`` is (the lower expert id first among equal probabilities):
``torch.topk`` promises no order among ties, a stable descending sort
does.  Products promote to the wider of the operands' dtypes, as jnp's
do (bf16 activations against f32 weights compute in f32).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import act_fn, dense_init, matmul, promoted


def init_moe(gen: torch.Generator, lead, d: int, cfg, gated: bool,
             dtype) -> dict:
    """Router (d, E) in f32; ``w_up`` / ``w_gate`` (E, d, f) and
    ``w_down`` (E, f, d) in ``dtype``; with a leading stacked-layer shape
    ``lead``."""
    lead = tuple(lead)
    e, f = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": dense_init(gen, lead + (d, e), torch.float32,
                             in_axis_size=d),
        "w_up": dense_init(gen, lead + (e, d, f), dtype, in_axis_size=d),
        "w_down": dense_init(gen, lead + (e, f, d), dtype, in_axis_size=f),
    }
    if gated:
        p["w_gate"] = dense_init(gen, lead + (e, d, f), dtype,
                                 in_axis_size=d)
    return p


def route(params: dict, xt: torch.Tensor, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (T, d).  Returns (probs (T, E) f32, gates (T, K) f32
    renormalized, idx (T, K) int64), the top-k in descending probability,
    the lower expert id first among ties."""
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = srt.values[:, :cfg.top_k]
    idx = srt.indices[:, :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def aux_loss(probs: torch.Tensor, idx: torch.Tensor, cfg) -> torch.Tensor:
    """The Switch load-balance loss: the top-1 choices' density times the
    mean router probability, summed over experts, x ``aux_loss_coef`` x E.
    probs (..., E), idx (..., K)."""
    E = cfg.n_experts
    density = F.one_hot(idx[..., 0].reshape(-1), E).float().mean(0)
    proxy = probs.reshape(-1, E).mean(0)
    return cfg.aux_loss_coef * E * torch.sum(density * proxy)


def capacity(T: int, cfg, capacity_factor: float) -> int:
    """Slots per expert: T (dropless) for ``capacity_factor <= 0``, else
    the reference's ``int(capacity_factor * K * T / E) or 1``."""
    if capacity_factor <= 0:
        return T
    return int(capacity_factor * cfg.top_k * T / cfg.n_experts) or 1


def queue_positions(idx: torch.Tensor, E: int) -> torch.Tensor:
    """idx (T, K) -> (T·K,) each pair's rank in its expert's queue, in
    (token, k) order."""
    flat = F.one_hot(idx.reshape(-1), E)
    return ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1)


def dispatch(params: dict, xt: torch.Tensor, gates: torch.Tensor,
             idx: torch.Tensor, cfg, activation: str,
             capacity_factor: float, tp=None) -> torch.Tensor:
    """The capacity-bounded expert FFN of routed tokens: xt (T, d), gates
    and idx (T, K) from `route` (or fed in).  A pair whose queue position
    reaches the capacity is dropped: it lands on the sentinel and its gate
    is zeroed.  Returns (T, d).

    With ``tp`` (a `repro_torch.parallel.tensor.ModelAxis`) the expert
    weights are this rank's E / M experts.  The routing, the capacity and
    the queue positions are the global ones (every rank routes every
    token alike); the rank runs only its experts' products, combines its
    pairs' shares, and the shares are summed over the axis.  The tokens
    and the gates enter the local experts through `ModelAxis.copy`."""
    T, d = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = capacity(T, cfg, capacity_factor)
    pos = queue_positions(idx, E)
    expert = idx.reshape(-1)
    keep = pos < cap
    gates_flat = torch.where(keep, gates.reshape(-1),
                             torch.zeros_like(gates.reshape(-1)))
    slot = torch.where(keep, expert * cap + pos,
                       torch.full_like(expert, E * cap))
    # (not repeat_interleave, whose output size costs a host sync)
    token_of_pair = torch.arange(T * K, device=xt.device) // K
    # the kept slots are distinct; only the sentinel is written twice
    idx_buf = torch.full((E * cap + 1,), T, dtype=torch.long,
                         device=xt.device).scatter(0, slot, token_of_pair)
    E_l, lo = E, 0
    if tp is not None:
        E_l = params["w_up"].shape[0]
        lo = tp.shard_start(E_l) * cap
        xt, gates_flat = tp.copy(xt), tp.copy(gates_flat)
        # the pairs of other ranks' experts read the zero sentinel row
        mine = (slot >= lo) & (slot < lo + E_l * cap)
        slot = torch.where(mine, slot - lo, torch.full_like(slot, E_l * cap))
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    dispatched = xt_pad[idx_buf[lo:lo + E_l * cap]].reshape(E_l, cap, d)
    act = act_fn(activation)
    up = matmul(dispatched, params["w_up"])
    if "w_gate" in params:
        up = act(matmul(dispatched, params["w_gate"])) * up
    else:
        up = act(up)
    expert_out = matmul(up, params["w_down"])
    flat_out = torch.cat([expert_out.reshape(E_l * cap, d),
                          expert_out.new_zeros((1, d))])
    per_k = flat_out[slot.reshape(T, K)]                    # (T, K, d)
    w = gates_flat.reshape(T, K).to(xt.dtype).to(per_k.dtype)
    out = torch.einsum("tkd,tk->td", per_k, w)
    return out if tp is None else tp.reduce(out.float()).to(out.dtype)


def moe_ffn(params: dict, x: torch.Tensor, cfg, activation: str,
            capacity_factor: float = 1.25, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output (B, S, d), aux loss f32 scalar).
    ``capacity_factor <= 0`` is dropless (the decode path).  ``tp``: this
    rank's experts over the 'model' axis (`dispatch`); the router and the
    aux loss stay whole on every rank."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    probs, gates, idx = route(params, xt, cfg)
    out = dispatch(params, xt, gates, idx, cfg, activation, capacity_factor,
                   tp)
    return out.reshape(B, S, d), aux_loss(probs, idx, cfg)


def moe_ffn_dense(params: dict, x: torch.Tensor, cfg, activation: str,
                  tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The oracle: every expert on every token, masked by the gates (E/K
    times the products of `moe_ffn`).  Returns ((B, S, d), aux).

    With ``tp`` (a `repro_torch.parallel.tensor.ModelAxis`) the expert
    weights are this rank's E / M experts, as in `dispatch`: the router
    and the gates stay whole on every rank, x and the local experts'
    gates enter the local products through `ModelAxis.copy`, and the
    local experts' f32 sum is summed over the axis and cast once."""
    B, S, d = x.shape
    E = cfg.n_experts
    probs, gates, idx = route(params, x.reshape(B * S, d), cfg)
    full = torch.zeros((B * S, E), dtype=torch.float32, device=x.device) \
        .scatter(1, idx, gates).reshape(B, S, E)
    aux = aux_loss(probs.reshape(B, S, E), idx.reshape(B, S, -1), cfg)
    if tp is not None:
        E_l = params["w_up"].shape[0]
        lo = tp.shard_start(E_l)
        # the whole gates through the edge, then the local experts'
        # columns: each rank's gradient lands on its own columns
        x, full = tp.copy(x), tp.copy(full)[..., lo:lo + E_l]
    act = act_fn(activation)
    up = torch.einsum("bsd,edf->bsef", *promoted(x, params["w_up"]))
    if "w_gate" in params:
        up = act(torch.einsum("bsd,edf->bsef",
                              *promoted(x, params["w_gate"]))) * up
    else:
        up = act(up)
    per_expert = torch.einsum("bsef,efd->bsed",
                              *promoted(up, params["w_down"]))
    out = torch.einsum("bsed,bse->bsd",
                       *promoted(per_expert, full.to(x.dtype)))
    if tp is not None:
        out = tp.reduce(out.float()).to(out.dtype)
    return out, aux

"""A shared probe of the port's vlm and encdec tests (not a test file):
greedy decode through the dense layout and through the paged layout,
with the prompt's extra inputs (a VLM's patches and M-RoPE positions, an
encoder-decoder's frames), so the two can be held bitwise equal; and
the limit the ``gpu`` tests hold B5 to at these families' shapes."""
import torch

from repro_torch import tree as T
from repro_torch.models.attention import attend_one
from repro_torch.models.cache import (DenseLayout, PagedLayout,
                                      _quantize_tokens)


class DequantizedDenseOps:
    """Dense f32 self k / v caches written the way an int8 page is: each
    token's k and v quantized and dequantized, so the dense decode sees
    the very values the paged gather dequantizes."""

    def __init__(self, pos: torch.Tensor):
        self.pos = pos

    def kv_attend(self, cache, qg, k_new, v_new, *, window):
        rows = torch.arange(qg.shape[0])
        for name, new in (("k", k_new), ("v", v_new)):
            qv, sc = _quantize_tokens(new[:, 0], "int8", 1)
            cache[name][rows, self.pos] = qv.float() * sc[:, None, None]
        valid = torch.arange(cache["k"].shape[1]) <= self.pos
        return attend_one(qg, cache["k"], cache["v"], valid), cache


def _step_batch(model, tokens, pos):
    batch = {"tokens": tokens, "pos": pos}
    if model.cfg.vlm is not None:
        batch["mrope_positions"] = pos.expand(3, 1)
    return batch


def dense_trace(model, params, batch: dict, offset: int, gen: int,
                cache_len: int, pools=None) -> list:
    """Greedy decode over the dense layout: the prefill's logits, then
    ``gen`` steps' (positions from P + ``offset``).  ``pools`` "bfloat16"
    casts the prefill's cache to bf16 (the paged storage at bf16
    compute); "int8" holds every self k / v as its int8 page would."""
    lay = DenseLayout(model)
    logits, cache = lay.prefill(params, batch, cache_len=cache_len)
    if pools == "bfloat16":
        cache = T.map(lambda a: a.to(torch.bfloat16), cache)
    elif pools == "int8":
        for unit in cache:
            for c in unit.values():
                for name in ("k", "v"):
                    qv, sc = _quantize_tokens(c[name], "int8", 3)
                    c[name].copy_(qv.float() * sc[..., None, None])
    trace = [logits]
    pos = torch.tensor(batch["tokens"].shape[1] + offset)
    for _ in range(gen):
        ops = DequantizedDenseOps(pos) if pools == "int8" else None
        logits, cache = model.decode_step(
            params, cache, _step_batch(model, trace[-1].argmax(-1)[:, None],
                                       pos), cache_ops=ops)
        trace.append(logits)
        pos = pos + 1
    return trace


def paged_trace(model, params, batch: dict, offset: int, gen: int,
                page_size: int, max_pages: int, kv_dtype=None) -> list:
    """The same greedy decode through `PagedLayout` (rows in slots 0 ..
    B-1, pages 1 ..), every row's block table ``max_pages`` wide."""
    B, P = batch["tokens"].shape
    lay = PagedLayout(model, n_slots=B, num_pages=B * max_pages + 1,
                      page_size=page_size, max_pages=max_pages,
                      kv_dtype=kv_dtype)
    pages = torch.arange(1, B * max_pages + 1).reshape(B, max_pages)
    logits, cache = lay.prefill_into(
        params, lay.init_cache(device="cpu"), batch,
        pages[:, :lay.pages_for(P + offset)], torch.arange(B))
    trace = [logits]
    pos = torch.full((B,), P + offset)
    for _ in range(gen):
        logits, cache = lay.decode_step(params, cache,
                                        logits.argmax(-1)[:, None], pos,
                                        pages)
        trace.append(logits)
        pos = pos + 1
    return trace


def flash_atol(dt, want):
    """B5's limit against its plain version: 2e-5 in f32; in bf16 3e-2
    of the largest output, at most 3e-2 (a softmax over ~1,000 keys
    averages v down to outputs of a few hundredths)."""
    if dt == torch.float32:
        return 2e-5
    return 3e-2 * min(1.0, float(want.float().abs().max()))

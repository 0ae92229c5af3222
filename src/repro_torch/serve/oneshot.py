"""Fixed-batch one-shot generation, the trivial case of the serve path
(the port of ``repro.serve.oneshot``).

`OneShotGenerator` prefills a batch of equal-length prompts and decodes
them together over the dense layout (`repro_torch.models.cache.
DenseLayout`).  The reference scans its decode loop inside one jitted
function; here a Python loop runs the steps and keeps every token on the
device until the end, with one device-to-host copy when the caller asks
for the tokens.  The continuous-batching path for request streams is
`repro_torch.serve.scheduler`.

Samplers take ``(logits, generator, temperature)``.  ``categorical`` draws
with the Gumbel-max trick from the caller's `torch.Generator`: the same
distribution as the reference's ``jax.random.categorical``, not its bits.

Over a 'model' axis (a model ``with_model_axis``) every rank runs the
loop on its shards and samples from the whole logits, which the model
gathers over the axis: greedy picks the same token on every rank, and
so does ``categorical`` when every rank seeds its generator alike (the
ranks then draw the same noise).  Only greedy is held to the reference,
whose draws are ``jax.random``'s.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def _greedy(logits: torch.Tensor, gen: Optional[torch.Generator],
            temperature: float) -> torch.Tensor:
    del gen, temperature
    return logits.argmax(dim=-1)


def _categorical(logits: torch.Tensor, gen: Optional[torch.Generator],
                 temperature: float) -> torch.Tensor:
    t = max(float(temperature), 1e-6)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return (logits.float() / t - torch.log(-torch.log(u))).argmax(dim=-1)


SAMPLERS: Dict[str, Callable] = {"greedy": _greedy,
                                 "categorical": _categorical}


def resolve_sampler(sampler: Optional[str], temperature: float) -> str:
    """Default: greedy at ``temperature <= 0``, categorical above."""
    if sampler is None:
        return "greedy" if temperature <= 0.0 else "categorical"
    return sampler


class OneShotGenerator:
    """Prefill + decode loop over the dense cache layout."""

    def __init__(self, model):
        self.model = model

    def __call__(self, params, prompts: torch.Tensor, *, gen: int,
                 sampler: Optional[str] = None, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 cache_len: Optional[int] = None,
                 extra_batch: Optional[dict] = None) -> torch.Tensor:
        """prompts: (B, P) int on the params' device -> (B, gen) generated
        ids, the prefill's sample first.

        ``extra_batch`` holds what the prompt carries besides its tokens,
        read by the prefill: a VLM's ``patches`` (B, n_patches, d), which
        come before the tokens and shift every decode position by
        n_patches, and ``mrope_positions`` (3, n_patches + P); an
        encoder-decoder's ``frames`` (B, n_frames, d), whose encoder
        output the cache keeps.  A VLM's decode steps take M-RoPE
        positions (3, 1) filled with the step's position.

        ``cache_len`` (>= n_patches + P + gen + 1) overrides the cache
        allocation; the result does not depend on it (positions past the
        current one are masked), and parity tests use it to match a paged
        layout's linearized length.  Over a 'model' axis of M it is
        rounded up to a multiple of M, so that the ranks' blocks of
        positions divide it."""
        model = self.model
        vlm = model.cfg.vlm is not None
        sample = SAMPLERS[resolve_sampler(sampler, temperature)]
        B, P = prompts.shape
        batch = {"tokens": prompts.long(), **(extra_batch or {})}
        offset = batch["patches"].shape[1] if vlm and "patches" in batch \
            else 0
        need = P + offset + gen + 1
        cache_len = need if cache_len is None else int(cache_len)
        if cache_len < need:
            raise ValueError(f"cache_len {cache_len} < prompt + gen + 1 = "
                             f"{need}")
        if getattr(model, "tp", None) is not None:
            cache_len = -(-cache_len // model.tp.size) * model.tp.size
        logits, cache = model.prefill(params, batch, cache_len=cache_len)
        tok = sample(logits, generator, temperature)
        pos = torch.full((), P + offset, dtype=torch.long,
                         device=prompts.device)
        out = [tok]
        # the reference's scan also runs a last step whose sample it drops
        for _ in range(gen - 1):
            step = {"tokens": tok[:, None], "pos": pos}
            if vlm:
                step["mrope_positions"] = pos.expand(3, 1)
            logits, cache = model.decode_step(params, cache, step)
            tok = sample(logits, generator, temperature)
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1)

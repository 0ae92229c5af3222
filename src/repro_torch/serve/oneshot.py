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
                 cache_len: Optional[int] = None) -> torch.Tensor:
        """prompts: (B, P) int on the params' device -> (B, gen) generated
        ids, the prefill's sample first.

        ``cache_len`` (>= P + gen + 1) overrides the cache allocation; the
        result does not depend on it (positions past the current one are
        masked), and parity tests use it to match a paged layout's
        linearized length."""
        model = self.model
        sample = SAMPLERS[resolve_sampler(sampler, temperature)]
        B, P = prompts.shape
        need = P + gen + 1
        cache_len = need if cache_len is None else int(cache_len)
        if cache_len < need:
            raise ValueError(f"cache_len {cache_len} < prompt + gen + 1 = "
                             f"{need}")
        logits, cache = model.prefill(params, {"tokens": prompts.long()},
                                      cache_len=cache_len)
        tok = sample(logits, generator, temperature)
        pos = torch.full((), P, dtype=torch.long, device=prompts.device)
        out = [tok]
        # the reference's scan also runs a last step whose sample it drops
        for _ in range(gen - 1):
            logits, cache = model.decode_step(
                params, cache, {"tokens": tok[:, None], "pos": pos})
            tok = sample(logits, generator, temperature)
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1)

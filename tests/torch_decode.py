"""A shared probe of the port's tests (not a test file): decode a short
prompt through one of the port's cache layouts, teacher-forced, beside
the whole-sequence forward."""
import torch

from repro_torch.models.cache import DenseLayout, PagedLayout


def short_prompt_decode(model, params, toks: torch.Tensor, P: int,
                        layout: str) -> torch.Tensor:
    """Prefill ``toks[:, :P]`` through ``layout`` ("dense" or "slot", the
    slot-indexed `PagedLayout` the scheduler serves), then decode the
    rest of ``toks`` one token at a time.  Returns the prefill's and
    every step's logits, (B, S - P + 1, V): those of positions P - 1 ...
    S - 1 of the whole sequence."""
    B, S = toks.shape
    if layout == "dense":
        lay = DenseLayout(model)
        logits, cache = lay.prefill(params, {"tokens": toks[:, :P]},
                                    cache_len=S + 1)

        def step(t, cache):
            return lay.decode_step(params, cache, {
                "tokens": toks[:, t:t + 1], "pos": torch.tensor(t)})
    else:
        lay = PagedLayout(model, n_slots=B, num_pages=2, page_size=8,
                          max_pages=1)
        cache = lay.init_cache(device="cpu")
        logits, cache = lay.prefill_into(
            params, cache, {"tokens": toks[:, :P]},
            torch.zeros((B, 0), dtype=torch.long), torch.arange(B))
        bt = torch.zeros((B, 1), dtype=torch.long)

        def step(t, cache):
            return lay.decode_step(params, cache, toks[:, t:t + 1],
                                   torch.full((B,), t), bt)
    out = [logits]
    for t in range(P, S):
        logits, cache = step(t, cache)
        out.append(logits)
    return torch.stack(out, dim=1)

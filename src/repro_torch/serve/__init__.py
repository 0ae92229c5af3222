"""The serving subsystem: paged KV cache + continuous batching (the port
of ``repro.serve``).

* `repro_torch.serve.pool`      — the refcounted page allocator
  (`PagePool`) and the prefix-page index (`PrefixCache`);
* `repro_torch.serve.scheduler` — the continuous-batching request
  scheduler (`Scheduler` / `Request`) over
  `repro_torch.models.cache.PagedLayout`;
* `repro_torch.serve.oneshot`   — fixed-batch generation over the dense
  layout (`OneShotGenerator`) and the `SAMPLERS`; `Engine.generate`
  delegates here.
"""
from repro_torch.serve.oneshot import SAMPLERS, OneShotGenerator
from repro_torch.serve.pool import PagePool, PrefixCache
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["SAMPLERS", "OneShotGenerator", "PagePool", "PrefixCache",
           "Request", "Scheduler"]

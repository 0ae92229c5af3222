"""Roofline terms of a traced call on an NVIDIA H100 (the port of
``repro.analysis.roofline``, whose constants are a TPU's).

    compute term    = Σ_op FLOPs_op / peak(math_op)
    memory term     = traced bytes / HBM bandwidth
    collective term = wire bytes / NVLink bandwidth
    tp term         = tensor-parallel collective bytes / NVLink bandwidth

The trace is `repro_torch.analysis.optrace`'s: FLOPs and bytes of every
aten op and hand-written kernel one call ran.  The compute term prices
each op at the peak of the arithmetic it actually runs in (``Op.math``):
a bf16 GEMM at the tensor cores' 989 TFLOP/s, an f32 GEMM with TF32 off
at the CUDA cores' 67, elementwise work at 67.

The W workers of a step share one card here, so their mean is HBM
traffic, already in the memory term.  The collective term is what the
same wire would cost a W-card layout over NVLink, and is reported beside
the step (``step_s`` = the larger of compute and memory), not added to
it.  ``collective_net_s`` prices the same bytes at the node network's
rate: on the production meshes the worker axis spans nodes of 8 GPUs,
so its wire crosses the network, not NVLink (the dry-run reads it).
``collective_tp_s`` prices the payload of the collectives a
tensor-parallel step issues over the 'model' axis (the trace's ``tp``
scope: its activation all-reduces, the replicated weights' gradient
all-reduces, the norms' sums) at NVLink's rate: the 'model' axis lies
within a node.  It too is reported beside the step, not added to it.

Constants: NVIDIA H100 SXM data sheet, dense (no sparsity); the node
network: NVIDIA DGX H100 data sheet, 8 ConnectX-7 400 Gb/s NDR
InfiniBand ports a node of 8 GPUs, 50 GB/s a GPU.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core import quant as Q
from repro_torch.core.types import InputShape, ModelConfig

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores (bf16 / f16)
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, tensor cores (TF32)
PEAK_FLOPS_F32 = 67e12        # FLOP/s, CUDA cores (f32, no tensor cores)
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s each way
NET_BW = 50e9                 # B/s a GPU: one 400 Gb/s NDR port (DGX H100)
GPUS_PER_NODE = 8

# Op.math -> peak FLOP/s; "tf32x3" is flash_attention's f32 path, three
# TF32 products per f32 one
PEAKS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
         "tf32": PEAK_FLOPS_TF32, "tf32x3": PEAK_FLOPS_TF32 / 3,
         "float32": PEAK_FLOPS_F32, "float64": 34e12}


def op_seconds(flops: float, math: str) -> float:
    """``flops`` at the peak of ``math`` (an ``Op.math``)."""
    return flops / PEAKS.get(math, PEAK_FLOPS_F32)


def kernel_bound(cost: dict) -> Tuple[float, str]:
    """The least time, in ms, the card could take for a kernel launch's
    work, and what bounds it (``"bytes"`` or ``"operations"``): the larger
    of its bytes over HBM and its FLOPs at the peak of its ``math``.
    ``cost`` is the kernel's cost function's dict (the wrapper's
    `repro_torch.instrument.traced_kernel` cost, the same one a trace
    records)."""
    byte_s = (cost.get("bytes_read", 0) + cost.get("bytes_written", 0)) \
        / HBM_BW
    op_s = op_seconds(cost.get("dot_flops", 0) + cost.get("flops", 0),
                      cost.get("math", "float32"))
    return max(byte_s, op_s) * 1e3, \
        "operations" if op_s > byte_s else "bytes"


@dataclass
class Roofline:
    flops: float               # traced FLOPs of the call
    hbm_bytes: float           # traced bytes read and written
    coll_bytes: float          # the wire's per-worker bytes
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str            # the larger of compute and memory
    model_flops: float         # 6·N_active·D (train) / 2·N·D, per chip
    useful_flops_ratio: float  # model_flops / traced FLOPs
    coll_breakdown: Dict[str, float]
    step_s: float              # max(compute_s, memory_s)
    collective_net_s: float = 0.0   # the wire over the node network
    tp_bytes: float = 0.0      # the tensor-parallel collectives' payload
    collective_tp_s: float = 0.0    # those bytes over NVLink

    def to_dict(self):
        return asdict(self)


def model_flops_per_step(cfg: ModelConfig, shape: InputShape,
                         n_chips: int) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) per chip.  Decode shapes process
    one token per sequence; training includes the backward pass (the 6),
    prefill and decode are forward only (2·N·D)."""
    n = cfg.n_active_params()
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * shape.tokens_per_step / n_chips


def analyze(trace, cfg: ModelConfig, shape: InputShape, n_chips: int,
            wire_dtype: Optional[str] = None) -> Roofline:
    """The roofline of one traced call (one device's).
    ``trace.meta["wire"]`` (set by
    `repro_torch.launch.engine.Engine.trace_train_step`) gives the wire:
    its element ``sizes`` and the reducer's ``wire_bytes``; ``wire_dtype``
    prices those elements at another wire dtype's width instead (one f32
    scale per row on a quantized wire)."""
    compute_s = sum(op_seconds(o.flops, o.math) for o in trace.ops)
    hbm = float(trace.bytes)
    memory_s = hbm / HBM_BW
    wire = trace.meta.get("wire", {})
    if wire_dtype is not None and wire:
        sizes = wire["sizes"]
        coll = sum(sizes) * Q.wire_itemsize(wire_dtype) + (
            Q.SCALE_BYTES * len(sizes) if Q.is_quantized(wire_dtype)
            else 0)
    else:
        coll = wire.get("bytes", 0)
    coll_s = coll / NVLINK_BW
    tp = float(trace.coll_bytes("tp"))
    flops = float(trace.flops)
    mf = model_flops_per_step(cfg, shape, n_chips)
    return Roofline(
        flops=flops, hbm_bytes=hbm, coll_bytes=float(coll),
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck="compute" if compute_s >= memory_s else "memory",
        model_flops=mf, useful_flops_ratio=mf / flops if flops else 0.0,
        coll_breakdown={"wire": float(coll), "tp": tp,
                        "dot_flops": float(trace.dot_flops),
                        "elementwise_flops": float(trace.elem_flops)},
        step_s=max(compute_s, memory_s), collective_net_s=coll / NET_BW,
        tp_bytes=tp, collective_tp_s=tp / NVLINK_BW)

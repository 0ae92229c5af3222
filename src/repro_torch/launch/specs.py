"""Abstract input / state builders for the dry-run (the port of
``repro.launch.specs``).

Everything here returns fake tensors (``torch._subclasses.fake_tensor.
FakeTensorMode``, the port's ``jax.eval_shape``): shapes, dtypes and
devices with no storage, so the full-size configs are built, sharded and
traced without allocating a byte.  All of them share one mode
(`fake_mode`): fake tensors of two modes do not mix.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.types import DCS3GDConfig, InputShape, ModelConfig

Tree = Any

# sliding-window override that makes dense / MoE / VLM archs sub-quadratic
# for the long_500k decode shape (a Mistral-style ring cache)
LONG_CONTEXT_WINDOW = 4096

_MODE = None


def fake_mode():
    """The one `FakeTensorMode` of this process's abstract trees."""
    global _MODE
    if _MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _MODE


def dryrun_model_config(cfg: ModelConfig, model_axis: int = 16
                        ) -> ModelConfig:
    """bf16 params / compute for the production layout; heads padded up
    to a multiple of the model axis when they do not divide it (whisper
    20 -> 32, qwen2-vl 28 -> 32, minicpm3 40 -> 48) so attention shards
    instead of replicating."""
    pad = 0
    if cfg.n_heads and cfg.n_heads % model_axis:
        pad = -(-cfg.n_heads // model_axis) * model_axis
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16", pad_heads_to=pad)


def variant_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """long_500k on full-attention archs switches to the sliding-window
    variant (ring cache); SSM / hybrid run natively."""
    if (shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid")
            and cfg.sliding_window == 0):
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW,
                                   name=cfg.name + "-sw4096")
    return cfg


def supports_shape(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family == "encdec":
        return False, ("whisper decoder context is 448 positions; 524k-token "
                       "decode is not meaningful for an enc-dec speech model "
                       "(skip noted in DESIGN.md)")
    return True, ""


def _vlm_text_len(cfg: ModelConfig, seq: int) -> int:
    return seq - cfg.vlm.n_patches


def _fake(shape, dtype) -> torch.Tensor:
    with fake_mode():
        return torch.empty(shape, dtype=dtype)


def _emb_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def train_batch_specs(cfg: ModelConfig, shape: InputShape, n_workers: int
                      ) -> Dict[str, torch.Tensor]:
    """Per-worker-stacked training batch: leaves (W, b, ...)."""
    assert shape.global_batch % n_workers == 0, (shape, n_workers)
    b = shape.global_batch // n_workers
    S = shape.seq_len
    W = n_workers
    i32, emb = torch.int32, _emb_dtype(cfg)
    if cfg.family == "vlm":
        St = _vlm_text_len(cfg, S)
        return {"tokens": _fake((W, b, St), i32),
                "labels": _fake((W, b, St), i32),
                "patches": _fake((W, b, cfg.vlm.n_patches, cfg.d_model), emb),
                "mrope_positions": _fake((W, 3, S), i32)}
    if cfg.family == "encdec":
        return {"tokens": _fake((W, b, S), i32),
                "labels": _fake((W, b, S), i32),
                "frames": _fake((W, b, cfg.encoder.n_frames, cfg.d_model),
                                emb)}
    return {"tokens": _fake((W, b, S), i32),
            "labels": _fake((W, b, S), i32)}


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape
                        ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    i32, emb = torch.int32, _emb_dtype(cfg)
    out = {"tokens": _fake((B, S), i32)}
    if cfg.family == "vlm":
        out["tokens"] = _fake((B, _vlm_text_len(cfg, S)), i32)
        out["patches"] = _fake((B, cfg.vlm.n_patches, cfg.d_model), emb)
        out["mrope_positions"] = _fake((3, S), i32)
    if cfg.family == "encdec":
        out["frames"] = _fake((B, cfg.encoder.n_frames, cfg.d_model), emb)
    return out


def decode_batch_specs(cfg: ModelConfig, shape: InputShape
                       ) -> Dict[str, torch.Tensor]:
    B = shape.global_batch
    out = {"tokens": _fake((B, 1), torch.int32),
           "pos": _fake((), torch.int32)}
    if cfg.family == "vlm":
        out["mrope_positions"] = _fake((3, 1), torch.int32)
    return out


def abstract_params(model) -> Tree:
    """``model``'s parameter tree as fake tensors (on the CPU device: a
    CPU generator drives ``Model.init``)."""
    with fake_mode():
        return model.init(torch.Generator())


def abstract_train_state(model, n_workers: int, dc_cfg: DCS3GDConfig,
                         algo="dc_s3gd"):
    """Abstract `TrainState` for the registry-built algorithm ``algo`` (a
    name or an already-constructed algorithm, one process: every W row)."""
    from repro_torch.core import registry
    alg = algo if not isinstance(algo, str) else \
        registry.make(algo, dc_cfg, n_workers=n_workers)
    params = abstract_params(model)
    with fake_mode():
        return alg.init(params)


def abstract_cache(model, shape: InputShape) -> Tree:
    with fake_mode():
        return model.init_cache(shape.global_batch, shape.seq_len,
                                device=torch.device("cpu"))

"""CNN models in PyTorch — the paper's own benchmark family (the port of
``repro.models.cnn``).

``resnet`` builds basic residual stages with norm-free residual scaling
(SkipInit: a 0-d ``scale`` per block, zero at init, which the rank-based
decay mask exempts from weight decay), ``vgg`` the plain conv stack.

Layouts are the reference's, so weights carry over 1:1 and the sorted-key
flatten order, the bucket plan and the decay mask see the same shapes:
parameters are HWIO and images NHWC.  `conv2d` permutes inside — the
weight to OIHW, the activations to channels_last-strided NCHW — and pads
as XLA's ``"SAME"`` does: at stride 2 the padding can be asymmetric
(H = 32, k = 3: 0 before, 1 after), which ``F.conv2d(padding=1)`` would
shift by one pixel.  The params tree holds only tensors: strides come
from the block shapes.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _conv_init(gen: torch.Generator, k: int, cin: int, cout: int
               ) -> torch.Tensor:
    return torch.randn((k, k, cin, cout), generator=gen,
                       device=gen.device) / math.sqrt(k * k * cin)


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC images (*, H, W, Cin) x HWIO weights -> NHWC (*, H', W', Cout),
    as ``lax.conv_general_dilated(x, w, (s, s), padding, ("NHWC", "HWIO",
    "NHWC"))``; ``padding`` is ``"SAME"`` or ``"VALID"``."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
    kh, kw = w.shape[:2]
    pad = (0, 0)
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(x.shape[1], kh, stride),
                          same_pads(x.shape[2], kw, stride))
        if t == b and l == r:
            pad = (t, l)
        else:
            x = F.pad(x, (0, 0, l, r, t, b))
    x = x.permute(0, 3, 1, 2)
    if x.device.type == "cpu":
        # the CPU (oneDNN) backward of a strided 1x1 conv on a
        # channels_last input crashes the process (torch 2.13): the CPU
        # gets plain NCHW
        x = x.contiguous()
    y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _resnet_strides(stages: Sequence[int]):
    return [2 if (bi == 0 and si > 0) else 1
            for si, n_blocks in enumerate(stages) for bi in range(n_blocks)]


def init_resnet(gen: torch.Generator, *, stages: Sequence[int] = (1, 1, 1),
                width: int = 16, n_classes: int = 10,
                in_channels: int = 3) -> dict:
    """Stem + basic residual stages + head, f32, on ``gen``'s device."""
    params = {"stem": _conv_init(gen, 3, in_channels, width)}
    cin = width
    blocks = []
    strides = iter(_resnet_strides(stages))
    for si, n_blocks in enumerate(stages):
        cout = width * (2 ** si)
        for _ in range(n_blocks):
            stride = next(strides)
            blk = {
                "conv1": _conv_init(gen, 3, cin, cout),
                "conv2": _conv_init(gen, 3, cout, cout),
                "scale": torch.zeros((), device=gen.device),
            }
            if stride != 1 or cin != cout:
                blk["proj"] = _conv_init(gen, 1, cin, cout)
            blocks.append(blk)
            cin = cout
    params["blocks"] = blocks
    params["head"] = torch.randn((cin, n_classes), generator=gen,
                                 device=gen.device) / math.sqrt(cin)
    return params


def resnet_apply(params: dict, images: torch.Tensor) -> torch.Tensor:
    x = torch.relu(conv2d(images, params["stem"]))
    for blk in params["blocks"]:
        # stride 2 iff the block widens channels (first block of a stage>0)
        stride = 2 if blk["conv1"].shape[2] != blk["conv1"].shape[3] else 1
        h = torch.relu(conv2d(x, blk["conv1"], stride=stride))
        h = conv2d(h, blk["conv2"])
        sc = x if "proj" not in blk else conv2d(x, blk["proj"], stride=stride)
        x = torch.relu(sc + blk["scale"] * h)
    return x.mean(dim=(1, 2)) @ params["head"]


def init_vgg(gen: torch.Generator, *, widths: Sequence[int] = (16, 32),
             n_classes: int = 10, in_channels: int = 3) -> dict:
    convs = []
    cin = in_channels
    for w in widths:
        convs.append(_conv_init(gen, 3, cin, w))
        convs.append(_conv_init(gen, 3, w, w))
        cin = w
    return {"convs": convs,
            "head": torch.randn((cin, n_classes), generator=gen,
                                device=gen.device) / math.sqrt(cin)}


def vgg_apply(params: dict, images: torch.Tensor) -> torch.Tensor:
    x = images
    for i, w in enumerate(params["convs"]):
        x = torch.relu(conv2d(x, w))
        if i % 2 == 1:
            # reduce_window(max, 2x2, stride 2, VALID): odd edges dropped
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return x.mean(dim=(1, 2)) @ params["head"]


def cnn_loss_fn(apply_fn):
    """Mean cross-entropy of ``apply_fn``'s logits against int labels."""
    def loss(params, batch):
        logp = torch.log_softmax(apply_fn(params, batch["images"]), dim=-1)
        gold = torch.gather(logp, -1, batch["labels"].long()[:, None])
        return -gold.mean()
    return loss


def strict_f32() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions (PyTorch
    leaves cuDNN's on by default): the reference computes in f32, and the
    CNN entry points hold the port to it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def top1_error(apply_fn, params, batch) -> torch.Tensor:
    logits = apply_fn(params, batch["images"])
    return 1.0 - (logits.argmax(-1) == batch["labels"].long()).float().mean()

"""ResNet feature extractors (fbresnet152 equivalent), port of the JAX
package's ``models/convnets.py``.

Replaces the reference's torchvision/Cadene wrappers (``vqa/models/
convnets.py``): a ResNet-v1 with bottleneck blocks, inference-mode
BatchNorm whose statistics are buffers (extraction and serving only, like
the reference, which never trains the CNN), and bf16 compute by default, as
the JAX trunk.  The convolutions are ``F.conv2d`` (cuDNN on the card; JAX
computes them with XLA, in no Pallas kernel).  Inside, the maps are NCHW in
``channels_last`` memory; the input and the output are NHWC, JAX's layout:
the output ``(B, H/32, W/32, 2048)`` f32 is what ``{split}set.att.npy``
stores and what ``MutanAtt`` reads.

The modules carry the reference's names (``conv1``, ``bn1``,
``layerS.B.conv{1,2,3}`` / ``bn{1,2,3}``, ``downsample.0`` / ``.1``), so a
torchvision-format ``state_dict`` loads as it is
(:func:`load_torch_resnet152`); ``models/from_jax.resnet_from_jax`` carries
a flax tree across.

Head semantics reproduced exactly:

* ``pooling=True`` applies the reference's quirky global pool
  ``x.sum(H).sum(W) / (H + W)`` (convnets.py:48-55: the **H+W** divisor,
  not H*W), after a 7x7/1 average pool when the map is at least 7x7;
* ``pooling=False`` returns the (B, H, W, C) feature map; the extractor
  then takes the *true* spatial mean for ``noatt``.

f32 parity on the card needs ``torch.backends.cudnn.allow_tf32 = False``
(cuDNN otherwise rounds f32 convolution operands to TF32).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

RESNET_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class FrozenBatchNorm(nn.Module):
    """Inference-only BN: y = (x - mean) / sqrt(var + eps) * weight + bias,
    folded into one multiply-add in the compute dtype.  The statistics are
    buffers under the reference's names (``weight``, ``bias``,
    ``running_mean``, ``running_var``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(dim))
        self.register_buffer("bias", torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        w = (self.weight * inv).to(x.dtype)
        b = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        return x * w[:, None, None] + b[:, None, None]


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
          padding: int = 0) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     bias=False)
    conv.weight.requires_grad_(False)
    return conv


def _apply(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The convolution with its weight in the input's (compute) dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(in_ch, features, 1)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = _conv(features, features, 3, stride, 1)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = FrozenBatchNorm(features * 4)
        self.downsample = (nn.Sequential(
            _conv(in_ch, features * 4, 1, stride),
            FrozenBatchNorm(features * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(_apply(self.conv1, x)))
        y = F.relu(self.bn2(_apply(self.conv2, y)))
        y = self.bn3(_apply(self.conv3, y))
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](_apply(self.downsample[0], x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet v1 trunk stopping before fc (reference forward_resnet,
    convnets.py:38-56).  ``x`` (B, H, W, 3) -> (B, H/32, W/32, 2048) f32,
    or (B, 2048) with ``pooling``; computed in ``dtype``."""

    def __init__(self, depths: Sequence[int] = RESNET_DEPTHS[152],
                 pooling: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depths = tuple(depths)
        self.pooling = pooling
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        in_ch = 64
        for stage, blocks in enumerate(self.depths):
            features = 64 * 2 ** stage
            layers = []
            for block in range(blocks):
                layers.append(Bottleneck(
                    in_ch, features,
                    stride=(1 if stage == 0 or block else 2),
                    downsample=block == 0))
                in_ch = features * 4
            self.add_module("layer%d" % (stage + 1), nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)        # NCHW view of NHWC
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(_apply(self.conv1, x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in range(len(self.depths)):
            x = getattr(self, "layer%d" % (stage + 1))(x)
        if self.pooling:
            if x.shape[2] >= 7 and x.shape[3] >= 7:
                x = F.avg_pool2d(x, 7, 1)
            h, w = x.shape[2], x.shape[3]
            return (x.sum(dim=(2, 3)) / float(h + w)).float()
        return x.permute(0, 2, 3, 1).float().contiguous()


def factory(opt: dict) -> ResNet:
    """Name dispatch (reference convnets.factory, convnets.py:20-99):
    fbresnet152 / fbresnet152torch and resnet{50,101,152} map to the trunk
    of their depth; weights tell them apart (:func:`load_torch_resnet152`)."""
    arch = opt["arch"]
    for depth in (152, 101, 50):
        if str(depth) in arch:
            return ResNet(depths=RESNET_DEPTHS[depth],
                          pooling=bool(opt.get("pooling", False)))
    raise ValueError("unsupported convnet arch %r" % arch)


def flax_conv_names(depths: Sequence[int]) -> list:
    """``(flax path, module name)`` of every convolution, the flax path as
    the JAX trunk's param tree names it (``layer1_0/downsample_conv``) and
    in its flattening order (keys sorted at every level), the module name
    as this trunk's (``layer1.0.downsample.0``)."""
    out = [(("conv1",), "conv1")]
    for stage, blocks in enumerate(depths):
        for block in range(blocks):
            flax_block = "layer%d_%d" % (stage + 1, block)
            ours = "layer%d.%d." % (stage + 1, block)
            out += [((flax_block, "conv%d" % i), ours + "conv%d" % i)
                    for i in (1, 2, 3)]
            if block == 0:
                out.append(((flax_block, "downsample_conv"),
                            ours + "downsample.0"))
    return sorted(out)


def flax_bn_names(depths: Sequence[int]) -> list:
    """``(flax path, module name)`` of every FrozenBatchNorm, as above."""
    return [(path[:-1] + (path[-1].replace("conv", "bn"),),
             name.replace("conv", "bn").replace("downsample.0",
                                                "downsample.1"))
            for path, name in flax_conv_names(depths)]


@torch.no_grad()
def init_resnet(model: ResNet, image_size: int = 448, seed: int = 0
                ) -> ResNet:
    """The JAX trunk's host init, draw for draw: conv kernels are fan-in
    normals from one ``np.random.default_rng(seed)`` in the flax tree's
    leaf order (HWIO, moved to OIHW here), BN the identity.  The random
    weights feed the weights-less smoke path; ported checkpoints
    overwrite them.  ``image_size`` is JAX's argument (its tree does not
    depend on it)."""
    del image_size
    rng = np.random.default_rng(seed)
    modules = dict(model.named_modules())
    for _, name in flax_conv_names(model.depths):
        weight = modules[name].weight
        out_ch, in_ch, kh, kw = weight.shape
        hwio = rng.normal(0.0, (1.0 / (kh * kw * in_ch)) ** 0.5,
                          (kh, kw, in_ch, out_ch)).astype(np.float32)
        weight.copy_(torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy()))
    for module in model.modules():
        if isinstance(module, FrozenBatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    return model


def load_torch_resnet152(model: ResNet, state_dict_path: str) -> ResNet:
    """Load a torchvision-format ResNet ``state_dict`` (a raw ``torch.save``
    of tensors) into ``model`` in place.  ``fc.*`` and the BN
    ``num_batches_tracked`` counters are ignored (the trunk stops before fc,
    like the reference); a missing or unexpected key raises
    ``ValueError``."""
    sd = torch.load(state_dict_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    want = set(model.state_dict())
    missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
    if missing or extra:
        raise ValueError("port missing params: %s; unexpected: %s"
                         % (missing[:5], extra[:5]))
    model.load_state_dict(sd)
    return model


def preprocess_image(img, size: int = 448):
    """PIL image -> normalized float32 (H, W, 3): Scale -> CenterCrop ->
    ToTensor -> ImageNet Normalize (reference coco.py:84-92 transform)."""
    arr = preprocess_image_uint8(img, size).astype(np.float32) / 255.0
    arr = (arr - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    return arr.astype(np.float32)


def preprocess_image_uint8(img, size: int = 448):
    """Scale -> CenterCrop only, as uint8 (H, W, 3): the host half of the
    transform.  Pair with :func:`normalize_images_device`: the uint8 form
    is 4x smaller on the host-to-device copy."""
    w, h = img.size
    if w < h:
        nw, nh = size, int(round(h * size / w))
    else:
        nw, nh = int(round(w * size / h)), size
    img = img.resize((nw, nh), resample=2)  # PIL.Image.BILINEAR
    left = (nw - size) // 2
    top = (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device):
    """The mean and std as f32 tensors on ``device``, made once: a copy to
    the card inside a CUDA graph's capture is illegal."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize_images_device(x: torch.Tensor) -> torch.Tensor:
    """Device half of the transform: uint8 (..., 3) -> ToTensor + ImageNet
    Normalize in f32 on ``x``'s device, matching :func:`preprocess_image`."""
    mean, std = _imagenet_stats(x.device)
    x = x.float() / 255.0
    return (x - mean) / std

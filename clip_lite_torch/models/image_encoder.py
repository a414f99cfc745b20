"""Image tower wrapper, the counterpart of the JAX package's
``models/image_encoder.py``: a registered backbone by name, classifier
chopped.  The registry holds the ResNets (their classifier chopped, at
``width``), the VGGs (which keep their classifier and emit 1000 features,
as in the JAX package) and the model zoo's backbones as ``zoo::<name>``.
``frozen`` keeps the backbone in eval mode with no gradients; ``bn_mode``
``sync`` takes the BatchNorm statistics over the ranks, for the ResNets
and VGGs: the zoo towers keep theirs per rank, as the JAX registry drops
their ``bn_axis_name``.

:func:`detectron2_backbone_state_dict` exports a ResNet tower for
Detectron2, as the JAX package's function of that name does: the
torchvision layout (:func:`torchvision_resnet_state_dict`), renamed to
Detectron2's stem/res2..res5 convention.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from clip_lite_torch.models.resnet import RESNETS, ResNet
from clip_lite_torch.models.vgg import VGGS
from clip_lite_torch.models.zoo import zoo_backbones
from clip_lite_torch.ops.layers import BatchNorm, StepRNG

BACKBONES: Dict[str, Any] = dict(RESNETS)
BACKBONES.update(VGGS)
BACKBONES.update(zoo_backbones())


class ImageEncoder(nn.Module):
    """Maps (B, H, W, 3) NHWC images to (B, feature_size) fp32 features."""

    def __init__(self, img_enc_net: str = "resnet50", frozen: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_mode: str = "local", width: int = 64):
        super().__init__()
        if img_enc_net not in BACKBONES:
            raise KeyError(f"Unknown visual backbone {img_enc_net!r}. "
                           f"Choices: {sorted(BACKBONES)}")
        if bn_mode not in ("local", "sync"):
            raise ValueError(f"Unknown BN_MODE {bn_mode!r}")
        self.frozen = frozen
        kwargs = {"width": width} if img_enc_net in RESNETS else {}
        self.backbone = BACKBONES[img_enc_net](compute_dtype=compute_dtype,
                                               **kwargs)
        self.takes_rng = img_enc_net in VGGS  # the classifier's dropout
        if not img_enc_net.startswith("zoo::"):
            for module in self.backbone.modules():
                if isinstance(module, BatchNorm):
                    module.sync = bn_mode == "sync"  # over the ranks
        self.feature_size = self.backbone.feature_size
        if frozen:
            self.backbone.requires_grad_(False)

    def train(self, mode: bool = True) -> "ImageEncoder":
        super().train(mode)
        if self.frozen:
            self.backbone.eval()
        return self

    def forward(self, image: torch.Tensor,
                rng: Optional[StepRNG] = None) -> torch.Tensor:
        """``rng``: the step's draws, which VGG's dropout needs in
        training."""
        if self.takes_rng:
            return self.backbone(image, rng=rng)
        return self.backbone(image)


def torchvision_resnet_state_dict(backbone: ResNet) -> Dict[str, np.ndarray]:
    """The tower's weights and BatchNorm statistics in torchvision's layout
    and names (``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}``, ``.bn{i}``,
    ``.downsample.0``/``.1``), as C-order float32 numpy arrays."""
    sd = {k: v.detach().contiguous().cpu().numpy()
          for k, v in backbone.state_dict().items()}
    out: Dict[str, np.ndarray] = {}

    def conv_bn(dst_conv: str, dst_bn: str, src: str) -> None:
        out[f"{dst_conv}.weight"] = sd[f"{src}.conv.weight"]
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst_bn}.{leaf}"] = sd[f"{src}.bn.{leaf}"]

    conv_bn("conv1", "bn1", "stem")
    for name in backbone.block_names:  # layer{stage}_{block}
        stage, block = name[len("layer"):].split("_")
        dst = f"layer{stage}.{block}"
        i = 1
        while f"{name}.block{i}.conv.weight" in sd:
            conv_bn(f"{dst}.conv{i}", f"{dst}.bn{i}", f"{name}.block{i}")
            i += 1
        if f"{name}.shortcut.conv.weight" in sd:
            conv_bn(f"{dst}.downsample.0", f"{dst}.downsample.1",
                    f"{name}.shortcut")
    return out


_DETECTRON2_RENAME = {
    "layer1": "res2",
    "layer2": "res3",
    "layer3": "res4",
    "layer4": "res5",
    "bn1": "conv1.norm",
    "bn2": "conv2.norm",
    "bn3": "conv3.norm",
    "downsample.0": "shortcut",
    "downsample.1": "shortcut.norm",
}


def detectron2_backbone_state_dict(backbone: ResNet) -> dict:
    """A Detectron2-loadable checkpoint dict of a ResNet tower:
    ``{"model": {name: array}, "__author__", "matching_heuristics": True}``
    with the stages renamed res2..res5, the norms ``convN.norm``, the
    projections ``shortcut``, and the stem's names under ``stem.``."""
    d2: Dict[str, np.ndarray] = {}
    for name, value in torchvision_resnet_state_dict(backbone).items():
        for old, new in _DETECTRON2_RENAME.items():
            name = name.replace(old, new)
        if not name.startswith("res"):
            name = f"stem.{name}"
        d2[name] = value
    return {"model": d2, "__author__": "clip_lite_torch",
            "matching_heuristics": True}

"""Detection-eval interop: export a trained image tower for Detectron2, the
counterpart of the JAX package's ``voc_det.py``.  The detection fine-tune
itself runs inside Detectron2; this writes the ``.pkl`` it loads, with
its naming (stem, res2..res5, ``convN.norm``, ``shortcut``), from the
checkpoint's ResNet tower loaded into the port's own model on the run's
device.

Run:
    python -m clip_lite_torch.voc_det --pretrain-config <yaml> \
        --checkpoint-path ckpt.msgpack --output backbone_d2.pkl [--device cpu]
"""

from __future__ import annotations

import pickle

import torch

from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.eval_utils import resolve_device
from clip_lite_torch.factories import VisualBackboneFactory
from clip_lite_torch.models.image_encoder import detectron2_backbone_state_dict
from clip_lite_torch.utils.checkpointing import load_model_variables
from clip_lite_torch.utils.common import (
    check_one_card,
    common_parser,
    common_setup,
)

parser = common_parser(description="Export backbone for Detectron2.")
parser.add_argument("--pretrain-config", required=True)
parser.add_argument("--pretrain-config-override", nargs="*", default=[])
parser.add_argument("--checkpoint-path", required=True)
parser.add_argument("--output", required=True, help="Output .pkl path.")


def main(_A) -> str:
    check_one_card(_A)
    device = resolve_device(_A.device)
    _C = Config(_A.pretrain_config, list(_A.pretrain_config_override))
    logger = common_setup(_C, _A, job_type="voc_det_export")

    variables = load_model_variables(_A.checkpoint_path)
    with torch.device("meta"):
        encoder = VisualBackboneFactory.from_config(_C)
    encoder = encoder.to_empty(device=device)
    encoder.load_state_dict(bridge.convert(
        {"params": variables["params"]["image_encoder"],
         "batch_stats": variables["batch_stats"]["image_encoder"]}, encoder))
    d2 = detectron2_backbone_state_dict(encoder.backbone)
    with open(_A.output, "wb") as f:
        pickle.dump(d2, f)
    logger.info("Exported %d tensors (%s) -> %s",
                len(d2["model"]), _C.MODEL.VISUAL.NETWORK_NAME, _A.output)
    return _A.output


__all__ = ["main", "parser"]


if __name__ == "__main__":
    main(parser.parse_args())

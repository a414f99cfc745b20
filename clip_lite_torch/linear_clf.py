"""Linear probe / fine-tune eval on ImageNet or iNaturalist, the
counterpart of the JAX package's ``linear_clf.py``: a ``num_classes``
head on the pretrained image tower, trained with cross-entropy under the
downstream config's optimizer and schedule, reporting the best val top-1.
``--frozen`` (the linear probe) runs the backbone in eval mode without
gradients; otherwise the whole tower fine-tunes.

As in the JAX package, every parameter stays in the optimizer, so with
``--frozen`` the coupled weight decay, momentum and Lookahead still move
the backbone (ROADMAP Queue 3); every parameter takes ``OPTIM.LR``, since
the paths ``backbone...`` and ``fc`` name neither tower of the LR groups.
Checkpoints go to ``<serialization dir>/linear_clf`` as the JAX package's
``TrainState`` tree of its ``LinearClassifier`` (``backbone/backbone/...``,
``fc``), so either package reads them.  Eval batches are not padded: in
eval mode a batch's rows do not depend on each other.

Run:
    python -m clip_lite_torch.linear_clf --config <downstream.yaml> \
        --pretrain-config <pretrain.yaml> --checkpoint-path ckpt.msgpack \
        [--frozen] [--device cpu]
The last line printed is ``{"top1": <best val top-1 percent>}``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.data.pipeline import DataLoader, infinite_batches
from clip_lite_torch.engine import TrainState
from clip_lite_torch.eval_utils import resolve_device
from clip_lite_torch.factories import (
    DownstreamDatasetFactory,
    OptimizerFactory,
    VisualBackboneFactory,
)
from clip_lite_torch.models.image_encoder import ImageEncoder
from clip_lite_torch.ops.layers import Linear, init_weights
from clip_lite_torch.utils.checkpointing import (
    CheckpointManager,
    load_model_variables,
)
from clip_lite_torch.utils.common import (
    check_one_card,
    common_parser,
    common_setup,
)
from clip_lite_torch.utils.metrics import TopkAccuracy
from clip_lite_torch.utils.timers import Timer

parser = common_parser(description="Linear probe / fine-tune eval.")
parser.add_argument("--pretrain-config", required=True)
parser.add_argument("--pretrain-config-override", nargs="*", default=[])
parser.add_argument("--checkpoint-path", default=None,
                    help="Pretrained checkpoint (None = random init probe).")
parser.add_argument("--frozen", action="store_true",
                    help="Linear probe: freeze the backbone.")
parser.add_argument("--log-every", type=int, default=100)
parser.add_argument("--checkpoint-every", type=int, default=2000)

NUM_CLASSES = {"imagenet": 1000, "imagenet2012": 1000, "inaturalist": 8142}


class LinearClassifier(nn.Module):
    """The image tower and a classification head ``fc``; with ``frozen``
    the tower runs in eval mode and gives no gradient."""

    def __init__(self, backbone: ImageEncoder, num_classes: int,
                 frozen: bool = False):
        super().__init__()
        self.backbone = backbone
        self.fc = Linear(backbone.feature_size, num_classes)
        self.frozen = frozen

    def train(self, mode: bool = True) -> "LinearClassifier":
        super().train(mode)
        if self.frozen:
            self.backbone.eval()
        return self

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.frozen):
            feats = self.backbone(image)
        return self.fc(feats)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean negative log-likelihood of ``labels``, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def make_train_step() -> Callable:
    """``train_step(state, batch) -> (state, loss)``: one cross-entropy
    step of ``state.model`` (a LinearClassifier) on ``batch``'s ``image``
    and ``label``, then the optimizer's update; the loss is a 0-d device
    tensor."""

    def train_step(state: TrainState, batch: Dict[str, object]
                   ) -> Tuple[TrainState, torch.Tensor]:
        model = state.model
        model.train()
        model.zero_grad(set_to_none=True)
        image = torch.as_tensor(batch["image"]).to(state.device,
                                                   non_blocking=True)
        label = torch.as_tensor(batch["label"]).to(state.device,
                                                   non_blocking=True)
        loss = cross_entropy(model(image), label)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


@torch.no_grad()
def eval_logits(state: TrainState, batch: Dict[str, object]) -> np.ndarray:
    model = state.model
    model.eval()
    image = torch.as_tensor(batch["image"]).to(state.device, non_blocking=True)
    return model(image).float().cpu().numpy()


def main(_A) -> float:
    check_one_card(_A)
    device = resolve_device(_A.device)
    _C_down = Config(_A.config, list(_A.config_override))
    _C = Config(_A.pretrain_config, list(_A.pretrain_config_override))
    logger = common_setup(_C_down, _A, job_type="linear_clf")

    train_ds = DownstreamDatasetFactory.from_config(_C_down, split="train")
    val_ds = DownstreamDatasetFactory.from_config(_C_down, split="val")
    # The head's width: the dataset's own class map where it has one, else
    # the table keyed on DATA.ROOT's trailing name.
    key = os.path.basename(os.path.normpath(_C_down.DATA.ROOT))
    if getattr(train_ds, "class_to_idx", None):
        num_classes = len(train_ds.class_to_idx)
    else:
        num_classes = NUM_CLASSES.get(key, 1000)
    on_card = device.type == "cuda"
    train_loader = DataLoader(train_ds, _C_down.OPTIM.BATCH_SIZE,
                              shuffle=True, num_workers=_A.cpu_workers,
                              seed=_C_down.RANDOM_SEED, pin_memory=on_card,
                              background=on_card)
    val_loader = DataLoader(val_ds, _C_down.OPTIM.BATCH_SIZE, shuffle=False,
                            drop_last=False, num_workers=_A.cpu_workers,
                            pin_memory=on_card, background=on_card)

    model = LinearClassifier(VisualBackboneFactory.from_config(_C),
                             num_classes, frozen=_A.frozen)
    init_weights(model, torch.Generator().manual_seed(_C_down.RANDOM_SEED))
    if _A.checkpoint_path:
        # The pretraining checkpoint's image tower (``image_encoder``).
        pretrained = load_model_variables(_A.checkpoint_path)
        model.backbone.load_state_dict(bridge.convert(
            {"params": pretrained["params"]["image_encoder"],
             "batch_stats": pretrained["batch_stats"]["image_encoder"]},
            model.backbone))
        logger.info("Loaded pretrained tower from %s", _A.checkpoint_path)
    model = model.to(device, memory_format=torch.channels_last if on_card
                     else torch.preserve_format)
    state = TrainState(step=0, model=model,
                       optimizer=OptimizerFactory.from_config(_C_down, model))
    train_step = make_train_step()

    manager = CheckpointManager(
        os.path.join(_A.serialization_dir, "linear_clf"), state=state)
    num_iterations = _C_down.OPTIM.NUM_ITERATIONS
    timer = Timer(total_iterations=num_iterations)
    batches = infinite_batches(train_loader)
    best_top1 = 0.0
    try:
        for iteration in range(1, num_iterations + 1):
            timer.tic()
            state, loss = train_step(state, next(batches))
            timer.toc()
            if iteration % _A.log_every == 0:
                logger.info("%s | CE %.4f", timer.stats, float(loss))
            if iteration % _A.checkpoint_every == 0 or \
                    iteration == num_iterations:
                acc = TopkAccuracy(top_k=1)
                for vb in val_loader:
                    acc(eval_logits(state, vb), np.asarray(vb["label"]))
                top1 = acc.get_metric()
                best_top1 = max(best_top1, top1)
                logger.info("VAL @ %d: top-1 %.2f%% (best %.2f%%)",
                            iteration, top1, best_top1)
                manager.checkpointables["state"] = state
                manager.step(iteration, metric=top1, mode="max")
        manager.wait()
    finally:
        batches.close()

    print(json.dumps({"top1": best_top1}))
    return best_top1


__all__ = ["LinearClassifier", "NUM_CLASSES", "cross_entropy", "eval_logits",
           "main", "make_train_step", "parser"]


if __name__ == "__main__":
    main(parser.parse_args())

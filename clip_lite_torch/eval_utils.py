"""Downstream-eval plumbing: the two towers and the loss's projection heads,
ready for inference.

The counterpart of the JAX package's ``eval_utils.py``.  Every eval
(retrieval, zero-shot, VOC classification, bias EDA) encodes images and
captions through :class:`EncoderBundle`: tower, projection head, then L2
normalisation, in fixed-size batches with the tail padded.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from clip_lite_torch.config import Config
from clip_lite_torch.factories import PretrainingModelFactory
from clip_lite_torch.ops.layers import init_weights, l2_normalize


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; CUDA unless the caller
    asks for the CPU, and an error when CUDA is asked for but absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


class EncoderBundle:
    """Two-tower encoders + projectors on one device, in eval mode.

    ``state_dict`` is a port state_dict (e.g. from
    ``bridge.from_jax_variables``); without one the weights are random,
    drawn from a generator seeded with ``config.RANDOM_SEED``.  Under
    ``config.AMP`` the towers and heads compute in bfloat16 with fp32
    parameters and fp32 normalization and softmax statistics.
    """

    def __init__(self, config: Config, state_dict: Optional[dict] = None,
                 batch_size: int = 128, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.batch_size = batch_size
        model = PretrainingModelFactory.from_config(config)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(
                config.RANDOM_SEED))
        else:
            model.load_state_dict(state_dict)
        memory_format = (torch.channels_last if self.device.type == "cuda"
                         else torch.preserve_format)
        self.model = model.eval().to(self.device, memory_format=memory_format)

    @torch.inference_mode()
    def _img_fn(self, images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        feats = self.model.project_image(self.model.encode_image(
            x.to(self.device)))
        return l2_normalize(feats).cpu().numpy()

    @torch.inference_mode()
    def _txt_fn(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        batch = {"input_ids": torch.from_numpy(ids).long().to(self.device),
                 "attention_mask": torch.from_numpy(mask).long().to(self.device)}
        feats = self.model.project_text(self.model.encode_text(batch))
        return l2_normalize(feats).cpu().numpy()

    def encode_images(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) fp32 -> (N, D) fp32."""
        return _chunked(self._img_fn, self.batch_size, images)

    def encode_texts(self, texts: List[str], tokenizer) -> np.ndarray:
        """Captions -> (N, D) fp32, tokenized to DATA.MAX_CAPTION_LENGTH."""
        enc = tokenizer(list(texts), padding="max_length", truncation=True,
                        max_length=self.config.DATA.MAX_CAPTION_LENGTH)
        ids = np.asarray(enc["input_ids"], np.int32)
        mask = np.asarray(enc["attention_mask"], np.int32)
        return _chunked(self._txt_fn, self.batch_size, ids, mask)


def _chunked(fn: Callable, batch_size: int, *arrays) -> np.ndarray:
    """Apply ``fn`` over N rows in batches of ``batch_size``; the last batch
    is padded with copies of its last row and the padding sliced off."""
    n = arrays[0].shape[0]
    outs = []
    for start in range(0, n, batch_size):
        chunk = [a[start: start + batch_size] for a in arrays]
        pad = batch_size - chunk[0].shape[0]
        if pad:
            chunk = [np.concatenate(
                [c, np.repeat(c[-1:], pad, axis=0)], axis=0) for c in chunk]
        out = np.asarray(fn(*chunk))
        outs.append(out[: batch_size - pad] if pad else out)
    return np.concatenate(outs, axis=0)


def itm_eval(scores_i2t: np.ndarray, scores_t2i: np.ndarray,
             txt2img: dict, img2txt: dict) -> dict:
    """Image-text retrieval recalls R@1/5/10 in both directions.

    scores_i2t: (num_images, num_texts); img2txt maps an image index to the
    list of its ground-truth text indices; txt2img the reverse.
    """
    ranks = np.zeros(scores_i2t.shape[0])
    for index, score in enumerate(scores_i2t):
        order = np.argsort(score)[::-1]
        pos = np.isin(order, img2txt[index]).nonzero()[0]
        ranks[index] = pos.min() if pos.size else 1e20
    tr1, tr5, tr10 = [100.0 * (ranks < k).mean() for k in (1, 5, 10)]

    ranks = np.zeros(scores_t2i.shape[0])
    for index, score in enumerate(scores_t2i):
        order = np.argsort(score)[::-1]
        ranks[index] = np.where(order == txt2img[index])[0][0]
    ir1, ir5, ir10 = [100.0 * (ranks < k).mean() for k in (1, 5, 10)]

    tr_mean = (tr1 + tr5 + tr10) / 3
    ir_mean = (ir1 + ir5 + ir10) / 3
    return {
        "txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10, "txt_r_mean": tr_mean,
        "img_r1": ir1, "img_r5": ir5, "img_r10": ir10, "img_r_mean": ir_mean,
        "r_mean": (tr_mean + ir_mean) / 2,
    }

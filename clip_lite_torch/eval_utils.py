"""Downstream-eval plumbing: the two towers and the loss's projection heads,
ready for inference.

The counterpart of the JAX package's ``eval_utils.py``.  Every eval
(retrieval, zero-shot, VOC classification, bias EDA) encodes images and
captions through :class:`EncoderBundle`: tower, projection head, then L2
normalisation, in fixed-size batches with the tail padded.  The weights
come from a checkpoint of either package (a full one or a climax
snapshot), from a port state_dict, or are seeded.  The text tower's input
follows MODEL.TEXTUAL.NAME, as in the JAX package: token ids and masks, a
glove word dictionary's ids, or (sbert) precomputed sentence vectors.
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

    The weights are ``checkpoint_path``'s (the JAX package's msgpack
    format, a full checkpoint or a climax snapshot, written by either
    package): its ``params`` and ``batch_stats``, the fast weights and not
    the Lookahead slow ones, as the JAX package's evals take them.  Or
    ``state_dict``'s, a port state_dict (e.g. from
    ``bridge.from_jax_variables``); with neither, random weights drawn from
    a generator seeded with ``config.RANDOM_SEED``.  ``project`` adds the
    loss's projection heads after the towers and ``normalize`` the L2
    normalisation, as in the JAX package.  Under ``config.AMP`` the towers
    and heads compute in bfloat16 with fp32 parameters and fp32
    normalization and softmax statistics.
    """

    def __init__(self, config: Config, checkpoint_path: Optional[str] = None,
                 batch_size: int = 128, project: bool = True,
                 normalize: bool = True, *, state_dict: Optional[dict] = None,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.project, self.normalize = project, normalize
        model = PretrainingModelFactory.from_config(config)
        if checkpoint_path is not None:
            if state_dict is not None:
                raise ValueError("pass checkpoint_path or state_dict, not both")
            # Here, not at the top: checkpointing imports the engine, which
            # imports this module.
            from clip_lite_torch.bridge import convert
            from clip_lite_torch.utils.checkpointing import load_model_variables

            state_dict = convert(load_model_variables(checkpoint_path), model)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(
                config.RANDOM_SEED))
        else:
            model.load_state_dict(state_dict)
        memory_format = (torch.channels_last if self.device.type == "cuda"
                         else torch.preserve_format)
        self.model = model.eval().to(self.device, memory_format=memory_format)

    def _finish(self, feats: torch.Tensor, project: Callable) -> np.ndarray:
        if self.project:
            feats = project(feats)
        if self.normalize:
            feats = l2_normalize(feats)
        return feats.float().cpu().numpy()

    @torch.inference_mode()
    def _img_fn(self, images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        return self._finish(self.model.encode_image(x.to(self.device)),
                            self.model.project_image)

    @torch.inference_mode()
    def _txt_fn(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        ids = torch.from_numpy(ids).long().to(self.device)
        if self.config.MODEL.TEXTUAL.NAME == "glove":
            batch = {"caption_tokens": ids}
        else:
            batch = {"input_ids": ids,
                     "attention_mask": torch.from_numpy(mask).long().to(
                         self.device)}
        return self._finish(self.model.encode_text(batch),
                            self.model.project_text)

    @torch.inference_mode()
    def _vec_fn(self, vectors: np.ndarray) -> np.ndarray:
        batch = {"caption_encodings": torch.from_numpy(
            np.ascontiguousarray(vectors, np.float32)).to(self.device)}
        return self._finish(self.model.encode_text(batch),
                            self.model.project_text)

    def encode_images(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) fp32 -> (N, D) fp32."""
        return _chunked(self._img_fn, self.batch_size, images)

    def encode_image_batches(self, batch_iter) -> np.ndarray:
        """The images of every batch of ``batch_iter`` (arrays, or dicts
        with an ``image``), encoded and joined."""
        outs = []
        for batch in batch_iter:
            img = batch["image"] if isinstance(batch, dict) else batch
            outs.append(_chunked(self._img_fn, self.batch_size,
                                 np.asarray(img)))
        return np.concatenate(outs, axis=0)

    def encode_texts(self, texts: List[str], tokenizer) -> np.ndarray:
        """Captions -> (N, D) fp32, tokenized to DATA.MAX_CAPTION_LENGTH:
        by ``tokenizer``'s call, or in the glove mode a ``GloveTokenizer``'s
        ``encode`` (no ``<start>``/``<eos>``, as the JAX bundle takes it)
        cut and padded with ``<pad>``.  The sbert mode encodes sentence
        vectors instead (:meth:`encode_caption_encodings`)."""
        seq = self.config.DATA.MAX_CAPTION_LENGTH
        mode = self.config.MODEL.TEXTUAL.NAME
        if mode == "sbert":
            raise ValueError(
                "the sbert text mode takes precomputed sentence vectors "
                "(encode_caption_encodings); captions need a "
                "SentenceTransformer model, which the port does not have")
        if mode == "glove":
            pad = tokenizer.pad_id
            ids = np.full((len(texts), seq), pad, np.int32)
            for i, t in enumerate(texts):
                enc = tokenizer.encode(t)[:seq]
                ids[i, : len(enc)] = enc
            mask = (ids != pad).astype(np.int32)
        else:
            enc = tokenizer(list(texts), padding="max_length", truncation=True,
                            max_length=seq)
            ids = np.asarray(enc["input_ids"], np.int32)
            mask = np.asarray(enc["attention_mask"], np.int32)
        return _chunked(self._txt_fn, self.batch_size, ids, mask)

    def encode_caption_encodings(self, vectors: np.ndarray) -> np.ndarray:
        """The sbert mode's (N, 768) sentence vectors -> (N, D) fp32."""
        return _chunked(self._vec_fn, self.batch_size, np.asarray(vectors))


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

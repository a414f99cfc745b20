"""Experiment configuration for the PyTorch port.

The same key schema, defaults and override syntax as the JAX package's
``Config``, so every YAML under ``configs/`` loads unchanged:
defaults in code -> YAML merge -> dotted-key override list -> derived
RUN_ID -> frozen.  Keys that only the JAX package reads (``RNG_IMPL``,
``PARALLEL.*``, ``DATA.DEVICE_CACHE`` ...) are kept so that a config file
means the same thing to both packages.
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional

import yaml


class ConfigNode(dict):
    """A dict whose items are also attributes, supporting freeze/defrost."""

    _FROZEN_KEY = "__frozen__"

    def __init__(self, init: Optional[dict] = None):
        super().__init__()
        object.__setattr__(self, ConfigNode._FROZEN_KEY, False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"Config has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode._FROZEN_KEY):
            raise AttributeError(
                f"Cannot set {name!r}: config is frozen (immutable).")
        self[name] = ConfigNode(value) if isinstance(value, dict) and not isinstance(
            value, ConfigNode) else value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode._FROZEN_KEY):
            raise AttributeError(
                f"Cannot set {key!r}: config is frozen (immutable).")
        super().__setitem__(key, value)

    def freeze(self) -> None:
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        object.__setattr__(self, ConfigNode._FROZEN_KEY, True)

    def defrost(self) -> None:
        object.__setattr__(self, ConfigNode._FROZEN_KEY, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, ConfigNode._FROZEN_KEY)

    def merge_from_dict(self, other: dict, _path: str = "") -> None:
        for k, v in other.items():
            full = f"{_path}.{k}" if _path else k
            if k not in self:
                raise KeyError(f"Unknown config key: {full}")
            cur = self[k]
            if isinstance(cur, ConfigNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot overwrite subtree {full} with a leaf")
                cur.merge_from_dict(v, full)
            else:
                self[k] = _coerce(v, cur, full)

    def merge_from_file(self, path: str) -> None:
        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_dict(data)

    def merge_from_list(self, override_list: List[Any]) -> None:
        if len(override_list) % 2 != 0:
            raise ValueError("Override list must have even length (key value ...)")
        for key, value in zip(override_list[0::2], override_list[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                node = node[p]
                if not isinstance(node, ConfigNode):
                    raise KeyError(f"{key}: {p} is not a config subtree")
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            if isinstance(value, str):
                value = yaml.safe_load(value)
            node[leaf] = _coerce(value, node[leaf], key)

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v)
            for k, v in self.items()
        }

    def dump(self, stream=None) -> str:
        text = yaml.safe_dump(self.to_dict(), sort_keys=False)
        if stream is not None:
            stream.write(text)
        return text

    def clone(self) -> "ConfigNode":
        return ConfigNode(self.to_dict())

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.dump()

    __repr__ = __str__

    def __deepcopy__(self, memo):
        return ConfigNode(self.to_dict())

    def __reduce__(self):
        # Pickle as (class, (plain dict,)); freezing is not preserved.
        return (ConfigNode, (self.to_dict(),))


def _coerce(value: Any, current: Any, key: str) -> Any:
    """Coerce an override value to the type of the existing default."""
    if current is None or value is None:
        return value
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
        raise TypeError(f"{key}: cannot coerce {value!r} to bool")
    if isinstance(current, float) and isinstance(value, int):
        return float(value)
    if isinstance(current, str) and isinstance(value, bool):
        # Tri-state string keys (MODEL.TEXTUAL.FUSED_ATTENTION "auto")
        # accept YAML booleans.
        return "true" if value else "false"
    if isinstance(current, (list, tuple)):
        return list(value)
    if type(value) is not type(current) and not isinstance(value, type(current)):
        raise TypeError(
            f"{key}: type mismatch, default is {type(current).__name__}, "
            f"got {type(value).__name__}")
    return value


class Config:
    """Immutable experiment configuration.

    >>> _C = Config(override_list=["OPTIM.BATCH_SIZE", 1024])
    >>> _C.OPTIM.BATCH_SIZE
    1024
    """

    def __init__(self, config_file: Optional[str] = None,
                 override_list: Optional[List[Any]] = None):
        _C = ConfigNode()

        _C.RANDOM_SEED = 0
        # Mixed precision: compute in DTYPE with fp32 parameters and fp32
        # normalization statistics.
        _C.AMP = True
        _C.DTYPE = "bfloat16"
        _C.RNG_IMPL = "rbg"
        _C.CUDNN_DETERMINISTIC = False
        _C.CUDNN_BENCHMARK = True

        _C.DATA = ConfigNode()
        _C.DATA.NAME = "train_sbert"
        _C.DATA.ROOT = "datasets/serialized/"
        _C.DATA.IMAGE_CROP_SIZE = 224
        _C.DATA.MAX_CAPTION_LENGTH = 30
        _C.DATA.USE_SINGLE_CAPTION = False
        _C.DATA.USE_PERCENTAGE = 100.0
        _C.DATA.IMAGE_TRANSFORM_TRAIN = [
            "random_resized_crop",
            "horizontal_flip",
            "color_jitter",
            "normalize",
        ]
        _C.DATA.IMAGE_TRANSFORM_VAL = [
            "smallest_resize",
            "center_crop",
            "normalize",
        ]
        _C.DATA.JSON_FILES_TRAIN = []
        _C.DATA.JSON_FILES_VAL = []
        # Type of negative sampling: {'normal', 'clusters'}.
        _C.DATA.NEGATIVE_SAMPLING = "normal"
        _C.DATA.NEGATIVE_SAMPLING_START_ITERATION = 250000
        _C.DATA.CLUSTER_PATH = ""
        _C.DATA.COCO_ROOT = "datasets/coco/"
        _C.DATA.NUM_WORKERS = 4
        _C.DATA.PREFETCH = 2
        _C.DATA.NATIVE_PIPELINE = False
        _C.DATA.SEQ_BUCKETS = []
        _C.DATA.LENGTH_GROUP_BATCHES = 32
        _C.DATA.DEVICE_CACHE = False
        _C.DATA.CACHE_IMAGE_SIZE = 256
        _C.DATA.CACHE_PLACEMENT = "sharded"
        _C.DATA.CACHE_HOST_DIR = ""

        _C.MODEL = ConfigNode()
        _C.MODEL.NAME = "captions"
        _C.MODEL.VISUAL = ConfigNode()
        _C.MODEL.VISUAL.NETWORK_NAME = "resnet50"
        _C.MODEL.VISUAL.FEATURE_SIZE = 2048
        # ResNet base channel width: 64 = the torchvision family; smaller
        # values build architecture-faithful tiny towers for tests.
        _C.MODEL.VISUAL.WIDTH = 64
        _C.MODEL.VISUAL.FROZEN = False
        _C.MODEL.VISUAL.SELF_SUPERVISED = False
        _C.MODEL.VISUAL.PRETRAINED = False
        _C.MODEL.VISUAL.PRETRAINED_PATH = ""
        # "local" per-device BatchNorm statistics or "sync" cross-replica.
        _C.MODEL.VISUAL.BN_MODE = "local"
        _C.MODEL.VISUAL.REMAT = False

        _C.MODEL.TEXTUAL = ConfigNode()
        _C.MODEL.TEXTUAL.NAME = "train_sbert"
        _C.MODEL.TEXTUAL.PRETRAINED = False
        _C.MODEL.TEXTUAL.PRETRAINED_PATH = ""
        _C.MODEL.TEXTUAL.NETWORK_NAME = "bert-base-uncased"
        _C.MODEL.TEXTUAL.WORD_DICT_PATH = "datasets/vocab/word_dict.json"
        _C.MODEL.TEXTUAL.LOAD_GLOVE = False
        _C.MODEL.TEXTUAL.GLOVE_PATH = "datasets/glove/glove.42B.300d.txt"
        _C.MODEL.TEXTUAL.TRAIN_EMBEDDINGS = False
        _C.MODEL.TEXTUAL.TRANSFORM = False
        _C.MODEL.TEXTUAL.FEATURE_SIZE = 768
        _C.MODEL.TEXTUAL.SELF_SUPERVISED = False
        _C.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS = 12
        _C.MODEL.TEXTUAL.VOCAB_SIZE = 30522
        # BERT hidden width (768 = bert-base); heads and FFN scale with it
        # (hidden // 64, 4 * hidden).
        _C.MODEL.TEXTUAL.HIDDEN_SIZE = 768
        _C.MODEL.TEXTUAL.DROPOUT = 0.1
        # Fused attention kernel (ops/attention.py): "auto" takes the CUDA
        # kernel for tensors on a GPU; "false" forces the plain PyTorch
        # version; "true" forces the fused wrapper everywhere.
        _C.MODEL.TEXTUAL.FUSED_ATTENTION = "auto"

        _C.MODEL.LOSS = ConfigNode()
        _C.MODEL.LOSS.NAME = "jsd"
        # Critic function: {"dot", "concat", "dotcon", "condot"}
        _C.MODEL.LOSS.TYPE = "dot"
        _C.MODEL.LOSS.IMAGE_PRIOR = True
        _C.MODEL.LOSS.TEXT_PRIOR = True
        _C.MODEL.LOSS.PRIOR_WEIGHT = 0.1
        # Negative pairing scope under data parallelism: "local" or "global".
        _C.MODEL.LOSS.NEGATIVES = "global"

        _C.OPTIM = ConfigNode()
        _C.OPTIM.OPTIMIZER_NAME = "sgd"
        _C.OPTIM.SGD_MOMENTUM = 0.9
        _C.OPTIM.WEIGHT_DECAY = 0.0001
        _C.OPTIM.NO_DECAY = ".*textual.(embedding|transformer).*(norm.*|bias)"
        _C.OPTIM.CLIP_GRAD_NORM = 10.0

        _C.OPTIM.LOOKAHEAD = ConfigNode()
        _C.OPTIM.LOOKAHEAD.USE = True
        _C.OPTIM.LOOKAHEAD.ALPHA = 0.5
        _C.OPTIM.LOOKAHEAD.STEPS = 5

        _C.OPTIM.BATCH_SIZE = 256
        _C.OPTIM.CNN_LR = 0.2
        _C.OPTIM.LR = 0.001
        _C.OPTIM.TRANS_LR = 0.001
        _C.OPTIM.MIN_LR_MULT = 0.0
        _C.OPTIM.NUM_ITERATIONS = 500000
        _C.OPTIM.WARMUP_STEPS = 10000
        _C.OPTIM.LR_DECAY_NAME = "cosine"
        _C.OPTIM.LR_STEPS = []
        _C.OPTIM.LR_GAMMA = 0.1

        _C.PARALLEL = ConfigNode()
        _C.PARALLEL.DATA_AXIS = "data"
        _C.PARALLEL.NUM_DEVICES = 0
        _C.PARALLEL.DONATE = True
        _C.PARALLEL.STEPS_PER_CALL = 1
        _C.PARALLEL.ZERO1 = False

        _C.OPTIM.FUSED = True

        _C.RUN_ID = ""

        self._C = _C
        if config_file is not None:
            self._C.merge_from_file(config_file)
        if override_list:
            self._C.merge_from_list(list(override_list))

        self.add_derived_params()
        self._C.freeze()

    def add_derived_params(self) -> None:
        _C = self._C
        _C.RUN_ID = (
            "/V?" + _C.MODEL.VISUAL.NETWORK_NAME
            + "_T?" + _C.MODEL.TEXTUAL.NAME
            + "_Ty?" + _C.MODEL.LOSS.TYPE
            + "_Vs?" + str(_C.MODEL.VISUAL.SELF_SUPERVISED)
            + "_Ts?" + str(_C.MODEL.TEXTUAL.SELF_SUPERVISED)
            + "_N?" + _C.DATA.NEGATIVE_SAMPLING
            + "_B?" + str(_C.OPTIM.BATCH_SIZE)
            + "_O?" + _C.OPTIM.OPTIMIZER_NAME
            + "_B?" + str(_C.OPTIM.BATCH_SIZE)
            + "_D?" + _C.OPTIM.LR_DECAY_NAME
            + "_Ni?" + str(_C.OPTIM.NUM_ITERATIONS)
            + "_ID?" + _C.RUN_ID
        )

    def dump(self, file_path: str) -> None:
        with open(file_path, "w") as f:
            self._C.dump(stream=f)

    def dumps(self) -> str:
        return self._C.dump()

    def __getattr__(self, attr: str):
        return getattr(self._C, attr)

    def __str__(self) -> str:
        return str(self._C)

    def __repr__(self) -> str:
        return repr(self._C)

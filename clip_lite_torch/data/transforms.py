"""Image transform constants, the port's copy of the JAX package's
``data/transforms.py:28-29``.  The host transforms themselves come with
the data loaders (ROADMAP Queue 1, item 4)."""

IMAGENET_COLOR_MEAN = (0.485, 0.456, 0.406)
IMAGENET_COLOR_STD = (0.229, 0.224, 0.225)

__all__ = ["IMAGENET_COLOR_MEAN", "IMAGENET_COLOR_STD"]

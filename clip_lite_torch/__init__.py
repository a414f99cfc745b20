"""PyTorch port of clip_lite_tpu for NVIDIA GPUs (Hopper).

The JAX package stays beside it as the reference.  This package imports
nothing of JAX or of clip_lite_tpu; its tests hold it against the JAX
package on the CPU, and ``chip_smoke.py`` drives it on the card.
"""

from clip_lite_torch.config import Config

__all__ = ["Config"]

"""The U-Net and its layers (eval mode)."""

from .unet import (TPU_OPT_TOPOLOGY_VERSION, DynamicUnet,  # noqa: F401
                   build_unet, init_weights)
from .xresnet import ARCHS  # noqa: F401

"""Model layer: PixelNeRF field, encoder and factories."""

import torch

from .encoder import SpatialEncoder, make_encoder
from .pixelnerf import CondState, PixelNeRF, make_mlp


def make_model(conf, device="cuda", seed: int = 0,
               stop_encoder_grad: bool = False) -> PixelNeRF:
    """Build the model with random weights drawn from ``seed`` and move it,
    in eval mode, to ``device`` (the card unless the caller asks for the
    CPU).  stop_encoder_grad freezes the encoder (``--freeze_enc``)."""
    model_type = conf.get_string("type", "pixelnerf")
    if model_type != "pixelnerf":
        raise NotImplementedError("Unsupported model type", model_type)
    generator = torch.Generator().manual_seed(seed)
    return PixelNeRF(conf, generator=generator,
                     stop_encoder_grad=stop_encoder_grad).to(device).eval()


__all__ = [
    "CondState",
    "PixelNeRF",
    "SpatialEncoder",
    "make_encoder",
    "make_mlp",
    "make_model",
]

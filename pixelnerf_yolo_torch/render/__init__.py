"""Rendering layer: the NeRF volume renderer and the YOLO ray renderer."""

from .nerf import NeRFRenderer
from .yolo import YoloRenderer


def make_renderer(conf, lindisp: bool = False, device="cuda"):
    """Renderer from the root config; it renders on ``device`` (the card
    unless the caller asks for the CPU)."""
    renderer_type = conf.get_string("renderer.type", "nerf")
    if renderer_type == "nerf":
        return NeRFRenderer.from_conf(conf.get_config("renderer"),
                                      lindisp=lindisp, device=device)
    if renderer_type == "yolo":
        return YoloRenderer.from_conf(conf, device=device)
    raise NotImplementedError("Unsupported renderer type")


__all__ = ["NeRFRenderer", "YoloRenderer", "make_renderer"]

"""Rendering layer: the NeRF volume renderer."""

from .nerf import NeRFRenderer


def make_renderer(conf, lindisp: bool = False, device="cuda") -> NeRFRenderer:
    """Renderer from the root config; it renders on ``device`` (the card
    unless the caller asks for the CPU)."""
    renderer_type = conf.get_string("renderer.type", "nerf")
    if renderer_type == "nerf":
        return NeRFRenderer.from_conf(conf.get_config("renderer"),
                                      lindisp=lindisp, device=device)
    if renderer_type == "yolo":
        raise NotImplementedError(
            "the YOLO renderer is not ported yet (ROADMAP.md Queue 1 item 12)"
        )
    raise NotImplementedError("Unsupported renderer type")


__all__ = ["NeRFRenderer", "make_renderer"]

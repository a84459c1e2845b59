"""The flagship configuration (``_flagship()`` of the repo's
__graft_entry__.py).

NeRF mode: ResNet34 encoder with 4 layers (512-d latent), 5-block ResnetFC
with combine_layer 3, 6-frequency PE on xyz with viewdirs appended, 64
coarse + 32 fine (16 depth) samples, white background.  With
``use_code_viewdirs`` the PE covers [xyz, viewdirs] (78 z-features), which
keeps the PE out of the kernels (``PixelNeRF._pe_fusible``).

YOLO mode (``yolo=True``, with ``backbone="custom"`` as the bench runs it):
the same field emitting 7 values x 3 anchors on one scale, no fine MLP,
the YOLO renderer with 128 coarse samples and no fine samples.
"""

from __future__ import annotations

from .hocon import Config, parse_string


def flagship_conf(d_hidden: int = 512, backbone: str = "resnet34",
                  num_layers: int = 4, compute_dtype: str = "float32",
                  yolo: bool = False,
                  use_code_viewdirs: bool = False) -> Config:
    mlp = f"""type = resnet
           n_blocks = 5
           d_hidden = {d_hidden}
           combine_layer = 3
           combine_type = average"""
    mode = """d_out = 7
           num_scales = 1
           num_anchors_per_scale = 3
           yolo = True""" if yolo else ""
    fine = "type = empty" if yolo else mlp
    return parse_string(
        f"""
        model {{
            compute_dtype = {compute_dtype}
            use_encoder = True
            use_xyz = True
            use_code = True
            code {{ num_freqs = 6
                   freq_factor = 1.5
                   include_input = True }}
            use_viewdirs = True
            use_code_viewdirs = {use_code_viewdirs}
            mlp_coarse {{ {mlp}
                         {mode} }}
            mlp_fine {{ {fine} }}
            encoder {{ backbone = {backbone}
                      pretrained = False
                      num_layers = {num_layers}
                      index_padding = zeros }}
        }}
        renderer {{ type = {"yolo" if yolo else "nerf"}
                   n_coarse = {128 if yolo else 64}
                   n_fine = {0 if yolo else 32}
                   n_fine_depth = {0 if yolo else 16}
                   depth_std = 0.01
                   sched = []
                   white_bkgd = {not yolo}
                   eval_batch_size = 128 }}
        """
    )

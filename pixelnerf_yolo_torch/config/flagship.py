"""The flagship NeRF configuration (``_flagship()`` of the repo's
__graft_entry__.py in NeRF mode): ResNet34 encoder with 4 layers (512-d
latent), 5-block ResnetFC with combine_layer 3, 6-frequency PE on xyz with
viewdirs appended, 64 coarse + 32 fine (16 depth) samples, white
background."""

from __future__ import annotations

from .hocon import Config, parse_string


def flagship_conf(d_hidden: int = 512, backbone: str = "resnet34",
                  num_layers: int = 4,
                  compute_dtype: str = "float32") -> Config:
    mlp = f"""type = resnet
           n_blocks = 5
           d_hidden = {d_hidden}
           combine_layer = 3
           combine_type = average"""
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
            use_code_viewdirs = False
            mlp_coarse {{ {mlp} }}
            mlp_fine {{ {mlp} }}
            encoder {{ backbone = {backbone}
                      pretrained = False
                      num_layers = {num_layers}
                      index_padding = zeros }}
        }}
        renderer {{ type = nerf
                   n_coarse = 64
                   n_fine = 32
                   n_fine_depth = 16
                   depth_std = 0.01
                   sched = []
                   white_bkgd = True
                   eval_batch_size = 128 }}
        """
    )

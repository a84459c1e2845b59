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

``train_yolo_conf`` is the YOLO trainer's operating point, ``bench.py``'s
``train_yolo`` config: the trainer schema of the repo's
``__graft_entry__._DRYRUN_YOLO_CONF`` (train, yolo and loss sections,
256-px sources at image_scale 0.5, one 32-px cell scale) with the ELAN
backbone, a 5-block 512-wide ResnetFC, 128 coarse samples and chunks of
``yolo.ray_batch_size`` 1024 rays.
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


# the trainer schema of __graft_entry__._DRYRUN_YOLO_CONF at the widths
# bench.py's train_yolo config puts over it (d_hidden, n_blocks, backbone,
# num_layers, n_coarse, ray_batch_size 1024; compute_dtype a parameter)
_TRAIN_YOLO_CONF = """
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
    mlp_coarse {{ type = resnet
                 n_blocks = 5
                 d_hidden = 512
                 combine_layer = 3
                 combine_type = average
                 d_out = 7
                 num_scales = 1
                 num_anchors_per_scale = 3
                 yolo = True }}
    mlp_fine {{ type = empty }}
    encoder {{ backbone = custom
              pretrained = False
              num_layers = 4
              index_padding = zeros }}
}}
renderer {{ type = yolo
           n_coarse = 128
           n_fine = 0
           white_bkgd = False
           eval_batch_size = 128 }}
loss {{ lambda_coarse = 1.0 }}
train {{ print_interval = 2
        save_interval = 10000
        backup_interval = 10000
        vis_interval = 10000
        eval_interval = 10000
        metric_interval = 10000
        accu_grad = 1
        num_epoch_repeats = 1 }}
yolo {{
    image_scale = [0.5, 0.5]
    cell_sizes = [32]
    anchors = [
        [[0.02, 0.03], [0.04, 0.07], [0.08, 0.06]],
        [[0.07, 0.15], [0.15, 0.11], [0.14, 0.29]],
        [[0.28, 0.22], [0.38, 0.48], [0.9, 0.78]]
    ]
    ignore_iou_thresh = 0.5
    ray_batch_size = 1024
    weights {{ box_loss = 1
              object_loss = 20
              no_object_loss = 1
              class_loss = 1 }}
    early_restart = False
    nms_iou_threshold = 0.75
    nms_threshold = 0.45
    metric_views = [[0,2,3]]
    match_iou_threshold = 0.2
}}
"""


def train_yolo_conf(compute_dtype: str = "bfloat16") -> Config:
    return parse_string(_TRAIN_YOLO_CONF.format(compute_dtype=compute_dtype))

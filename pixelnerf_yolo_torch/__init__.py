"""PyTorch + CUDA port of pixelnerf_yolo_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (config/, utils/, nn/, ops/, models/,
render/, losses/, detect/).  The field MLP runs through hand-written CUDA kernels
(csrc/field_mlp_tc.cu in bf16, csrc/field_mlp_f32.cu in f32, bound in
ops/field_mlp.py).  This package imports
neither jax nor pixelnerf_yolo_tpu.
"""

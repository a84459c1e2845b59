"""PyTorch + CUDA port of pixelnerf_yolo_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (config/, utils/, nn/, ops/, models/,
render/, losses/, detect/).  The field MLP runs through hand-written CUDA kernels
(csrc/field_mlp.cu, bound in ops/field_mlp.py).  This package imports
neither jax nor pixelnerf_yolo_tpu.
"""

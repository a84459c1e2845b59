"""The benchmark's plain reference: pixelNeRF and NeRF-YOLO in float32
PyTorch, written from the published equations and the reference
implementation's conventions, with no kernel, cache or batching.

It imports neither JAX nor anything of the program under test: it builds
its own modules (module names chosen so that one weight dictionary loads
into both sides), renders, decodes, suppresses and trains on the inputs
and weights that the benchmark makes.  ``nets.set_lowp`` computes it in
float8 (the training cell's control, which a comparison has to reject)
or at a bfloat16 computation's rounding points (the yardstick a number
measures the program's gap against).
"""

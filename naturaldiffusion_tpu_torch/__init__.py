"""naturaldiffusion_tpu_torch — the PyTorch/CUDA port of naturaldiffusion_tpu.

Natural Inference (every sampler as a pair of lower-triangular coefficient
matrices run by one engine) on an NVIDIA H100, with the JAX package's Pallas
kernels rewritten by hand in CUDA C++ (``csrc/``).  Module paths mirror
``naturaldiffusion_tpu``; public functions keep its NHWC layout and its
``[3, 3, Cin, Cout]`` conv weights.  The package imports torch and numpy
only, never JAX or the JAX package.
"""

__version__ = "0.1.0"

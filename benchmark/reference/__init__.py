"""The benchmark's plain references: float32 PyTorch and NumPy, frozen.

Each module is written from the published description of its model (and
checked against the port at small sizes by ``benchmark/tests``), with the
parameter names the port uses, so that one seeded fill
(:mod:`benchmark.harness.weights`) gives both sides the same weights.
Nothing here imports the port, JAX or the JAX package.  Every product goes
through a :class:`.precision.Precision`: float32 with TF32 off for the
reference, or float8 (e4m3) rounding of both operands for the control.
"""

"""Evaluation of the port: FID and IS (``fid``) over pytorch-fid's
InceptionV3 (``inception``).  ``eval/likelihood.py`` of the JAX package
needs derivatives through the kernels and waits for the training slice."""

from .fid import (activations, compute_statistics, fid_from_samples,
                  frechet_distance, inception_score)

__all__ = ["frechet_distance", "compute_statistics", "activations",
           "inception_score", "fid_from_samples"]

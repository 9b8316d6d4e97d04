"""Model definitions (NHWC) and weight conversion."""

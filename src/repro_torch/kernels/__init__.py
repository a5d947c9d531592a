"""Hand-written Hopper kernels (csrc/), their plain PyTorch versions and
the device-routing wrappers in `ops`."""

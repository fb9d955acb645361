"""Hand-written Hopper kernels (csrc/), their layout and their wrappers."""

"""Plain torch ops (the oracles of the Hopper kernels) and ops/hopper."""

"""The port's kernels: each a CUDA source under csrc/ and its plain torch
version, behind one wrapper per kernel."""

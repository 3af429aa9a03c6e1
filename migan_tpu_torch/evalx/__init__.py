"""Evaluation of the port: the FID Inception detector (both flavors),
LPIPS-alex and the Frechet distance, in plain PyTorch and numpy."""

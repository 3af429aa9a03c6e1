"""Evaluation of the port: the FID Inception detector (both flavors),
LPIPS-alex, FID statistics and the Frechet distance, the training-time
metric registry and the per-image evaluators, in plain PyTorch and numpy."""

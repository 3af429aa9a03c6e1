"""The yardstick: a plain float32 MI-GAN deploy generator and the serve
path's pre- and post-processing, written from the published model
(Picsart-AI-Research/MI-GAN, `lib/model_zoo/migan_inference.py` and
`scripts/demo.py`), and the FLOP, byte and peak arithmetic of the
per-layer metrics. Imports no module of the program."""

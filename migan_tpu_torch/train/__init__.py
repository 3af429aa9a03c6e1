"""Single-device MI-GAN training: losses, the train step, checkpoints and
the tick loop."""

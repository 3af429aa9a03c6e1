"""The MI-GAN deployment generator: plain forward (`migan_inference`) and
the kernel chain (`migan_kernels`)."""

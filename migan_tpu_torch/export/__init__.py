"""The app pipeline of the port (bbox crop, generator, feathered
composite) in PyTorch."""

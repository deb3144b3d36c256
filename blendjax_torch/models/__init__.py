"""blendjax_torch.models — TinyDetector, its layers, the train step and the
parameter conversion from the JAX package's pytrees."""

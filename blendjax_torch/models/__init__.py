"""blendjax_torch.models — TinyDetector, the SeqFormer world model, their
layers, the train step and the parameter conversion from the JAX
package's pytrees."""

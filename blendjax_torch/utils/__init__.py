"""blendjax_torch.utils — stage timing and device selection."""

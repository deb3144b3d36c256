"""blendjax_torch.obs — telemetry building blocks (latency histograms)."""

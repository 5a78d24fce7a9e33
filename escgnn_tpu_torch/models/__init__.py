"""PyTorch modules mirroring `escgnn_tpu/models` (flagship slice)."""

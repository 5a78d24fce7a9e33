"""The plain reference: NumPy, SciPy and plain PyTorch in float32 with
TF32 off. It imports nothing of the system under test and takes nothing
the system made; it rebuilds the ESC encoding, the batches, the model's
forward and backward and the optimizer from the raw graphs and the
weights that the benchmark draws."""

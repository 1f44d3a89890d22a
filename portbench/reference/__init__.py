"""The plain reference of the benchmark: float32 PyTorch, no kernels, no
batching tricks, and nothing of the program under test.  It takes the
weights and inputs the benchmark makes and hands to both sides."""

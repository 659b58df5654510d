"""Hand-written GPU kernels of the port."""

"""Twins of the JAX package's examples/ (python -m dxk_tpu_torch.examples.<name>)."""

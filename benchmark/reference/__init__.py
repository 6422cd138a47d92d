"""The plain reference of the ESS steps: PyTorch and NumPy only, float32
with TF32 off. It imports nothing of the program (``ess_tpu_torch``), of
the JAX package or of JAX, and takes nothing the program made."""

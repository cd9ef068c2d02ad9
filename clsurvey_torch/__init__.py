"""clsurvey_torch — the CLsurvey continual-learning framework in PyTorch,
with the kernels that ``clsurvey_tpu`` wrote in Pallas for the TPU written
by hand in CUDA for NVIDIA Hopper (``csrc/``).

It keeps ``clsurvey_tpu``'s module layout and names, so each module has a
counterpart there, and it reads and writes the same checkpoint, path and
result formats. It imports neither JAX nor ``clsurvey_tpu``."""

__version__ = "0.1.0"

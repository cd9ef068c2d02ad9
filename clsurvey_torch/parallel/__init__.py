"""Data parallel over torch.distributed (``parallel/mesh.py``)."""

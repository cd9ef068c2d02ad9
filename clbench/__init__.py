"""The benchmark of ``clsurvey_torch``, the PyTorch and CUDA port: its
harness, its traffic and configurations as data, its per-layer readers and
its plain reference. ``python3 -m clbench.run --help``; ``README.md``."""

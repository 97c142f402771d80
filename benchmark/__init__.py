"""The benchmark of the PyTorch and CUDA port (`ovmono3d_tpu_torch`): its
harness, traffic, per-layer readers and plain reference. See README.md."""

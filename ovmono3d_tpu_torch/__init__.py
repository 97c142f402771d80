"""ovmono3d_tpu_torch: the PyTorch + CUDA port of ovmono3d_tpu for the H100.

It runs OVMono3D-LIFT inference on oracle 2D boxes and its training step
(DINOv2 ViT-B/14 + Simple Feature Pyramid + RPN, box and cube heads), and
OVMono3D-GEO inference on oracle 2D boxes (SAM, Depth-Pro and the box fit,
geo/), with attention in hand-written CUDA kernels (csrc/). The JAX package
`ovmono3d_tpu` is its reference; this package never imports it, nor JAX.
Kernels are built with nvcc at first use, so importing needs neither a GPU
nor a CUDA toolkit.
"""

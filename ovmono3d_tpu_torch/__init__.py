"""ovmono3d_tpu_torch: the PyTorch + CUDA port of ovmono3d_tpu for the H100.

This slice runs OVMono3D-LIFT inference on oracle 2D boxes (DINOv2 ViT-B/14 +
Simple Feature Pyramid + cube head), with the trunk's attention in a
hand-written CUDA kernel (csrc/flash_attn_fwd.cu). The JAX package
`ovmono3d_tpu` is its reference; this package never imports it, nor JAX.
Kernels are built with nvcc at first use, so importing needs neither a GPU
nor a CUDA toolkit.
"""

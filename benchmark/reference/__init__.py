"""Plain float32 PyTorch reference of OVMono3D-LIFT: the trunks (DINOv2
ViT-B/14, SAM ViT-B/16), the Simple Feature Pyramid, the RPN, the box and
cube heads, the training losses, the SGD step and the oracle-2D inference.

It follows the published models (Cube R-CNN / OVMono3D on detectron2, the
DINOv2 and segment_anything encoders) and reads its weights from a flat
{name: tensor} dict in the port's parameter layout. It imports neither the
port nor JAX; `numerics.Ops` gives every product its precision, float32
with TF32 off, or the lower-precision control.
"""

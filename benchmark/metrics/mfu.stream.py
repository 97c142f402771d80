"""Model FLOPs of the traced stream window's images (gdino_flops.py
image_flops: the detector at the prompt's T tokens and the lift on its
slots) over the window and the bf16 peak."""
from benchmark import flops, gdino_flops


def read(run):
    if not run.traced or not run.work.get("images"):
        return None
    work = gdino_flops.image_flops(run.cfg, run.work["text_len"])
    return 100.0 * work * run.work["images"] / (
        run.traced["window_s"] * flops.BF16_PEAK)

"""Hard-coded Omni3D category splits (reference cubercnn/data/builtin.py).

These are dataset constants of the Omni3D benchmark (category universes per
split), reproduced so splits resolve identically.

A copy of ovmono3d_tpu/data/builtin.py: the port imports nothing of the JAX package, and a test
holds the copy to it.
"""
from __future__ import annotations

_CATEGORY_SETS: dict[str, frozenset[str]] = {
    "omni3d": frozenset({
        "chair", "table", "cabinet", "car", "lamp", "books", "sofa",
        "pedestrian", "picture", "window", "pillow", "truck", "door",
        "blinds", "sink", "shelves", "television", "shoes", "cup", "bottle",
        "bookcase", "laptop", "desk", "cereal box", "floor mat",
        "traffic cone", "mirror", "barrier", "counter", "camera", "bicycle",
        "toilet", "bus", "bed", "refrigerator", "trailer", "box", "oven",
        "clothes", "van", "towel", "motorcycle", "night stand", "stove",
        "machine", "stationery", "bathtub", "cyclist", "curtain", "bin",
    }),
    "omni3d_in": frozenset({
        "stationery", "sink", "table", "floor mat", "bottle", "bookcase",
        "bin", "blinds", "pillow", "bicycle", "refrigerator", "night stand",
        "chair", "sofa", "books", "oven", "towel", "cabinet", "window",
        "curtain", "bathtub", "laptop", "desk", "television", "clothes",
        "stove", "cup", "shelves", "box", "shoes", "mirror", "door",
        "picture", "lamp", "machine", "counter", "bed", "toilet",
    }),
    "omni3d_out": frozenset({
        "cyclist", "pedestrian", "trailer", "bus", "motorcycle", "car",
        "barrier", "truck", "van", "traffic cone", "bicycle",
    }),
    "SUNRGBD": frozenset({
        "bicycle", "books", "bottle", "chair", "cup", "laptop", "shoes",
        "towel", "blinds", "window", "lamp", "shelves", "mirror", "sink",
        "cabinet", "bathtub", "door", "toilet", "desk", "box", "bookcase",
        "picture", "table", "counter", "bed", "night stand", "pillow",
        "sofa", "television", "floor mat", "curtain", "clothes",
        "stationery", "refrigerator", "bin", "stove", "oven", "machine",
    }),
    "Hypersim_trainval": frozenset({
        "books", "chair", "towel", "blinds", "window", "lamp", "shelves",
        "mirror", "sink", "cabinet", "bathtub", "door", "toilet", "desk",
        "box", "bookcase", "picture", "table", "counter", "bed",
        "night stand", "pillow", "sofa", "television", "floor mat",
        "curtain", "clothes", "stationery", "refrigerator",
    }),
    "ARKitScenes": frozenset({
        "table", "bed", "sofa", "television", "refrigerator", "chair",
        "oven", "machine", "stove", "shelves", "sink", "cabinet", "bathtub",
        "toilet",
    }),
    "Objectron": frozenset({
        "bicycle", "books", "bottle", "camera", "cereal box", "chair",
        "cup", "laptop", "shoes",
    }),
    "KITTI": frozenset({"pedestrian", "car", "cyclist", "van", "truck"}),
    "nuScenes": frozenset({
        "pedestrian", "car", "truck", "traffic cone", "barrier",
        "motorcycle", "bicycle", "bus", "trailer",
    }),
    "SUNRGBD_test_novel": frozenset({
        "monitor", "bag", "dresser", "board", "printer", "keyboard",
        "painting", "drawers", "microwave", "computer", "kitchen pan",
        "potted plant", "tissues", "rack", "tray", "toys", "phone",
        "podium", "cart", "soundsystem",
    }),
    "ARKitScenes_test_novel": frozenset({"fireplace"}),
    "KITTI_test_novel": frozenset({"tram"}),
}


def get_omni3d_categories(dataset: str = "omni3d") -> frozenset[str]:
    """Category set of a dataset split (reference builtin.py:12-53)."""
    if dataset in _CATEGORY_SETS:
        return _CATEGORY_SETS[dataset]
    base = dataset.split("_")[0]
    if dataset.endswith("_novel"):
        key = dataset
    elif base == "Hypersim":
        # Hypersim test annotation does not contain 'toilet'.
        if dataset == "Hypersim_test":
            return _CATEGORY_SETS["Hypersim_trainval"] - {"toilet"}
        key = "Hypersim_trainval"
    else:
        key = base
    if key not in _CATEGORY_SETS:
        raise ValueError(f"{dataset} dataset is not registered.")
    return _CATEGORY_SETS[key]

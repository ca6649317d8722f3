"""Data layer: dataset scanning, sample reading, label codec, cropping,
augmentation, and the threaded input pipeline (reference L2 + pipeline parts
of L4; see SURVEY.md §1-2)."""

from annonet_jax.data.cache import SharedLruCache
from annonet_jax.data.codec import (
    decode_rgba_label_image,
    index_label_image_to_rgba_label_image,
    labeled_points_by_class,
    rgba_label_to_index_label,
)
from annonet_jax.data.dataset import (
    ImageFilenames,
    find_image_files,
    read_anno_classes_file,
)
from annonet_jax.data.crop import (
    CropOptions,
    extract_crop,
    random_rect_containing_point,
    randomly_crop_sample,
)
from annonet_jax.data.filters import ignore_classes, ignore_large_nonzero_regions
from annonet_jax.data.pipeline import Crop, CropPipeline, RegionFilterOptions
from annonet_jax.data.sample import (
    Sample,
    outpaint,
    read_sample,
    resize_image_bilinear,
    resize_label_image,
)

__all__ = [
    "Crop",
    "CropOptions",
    "CropPipeline",
    "ImageFilenames",
    "RegionFilterOptions",
    "Sample",
    "SharedLruCache",
    "extract_crop",
    "ignore_classes",
    "ignore_large_nonzero_regions",
    "random_rect_containing_point",
    "randomly_crop_sample",
    "decode_rgba_label_image",
    "find_image_files",
    "index_label_image_to_rgba_label_image",
    "labeled_points_by_class",
    "outpaint",
    "read_anno_classes_file",
    "read_sample",
    "resize_image_bilinear",
    "resize_label_image",
    "rgba_label_to_index_label",
]

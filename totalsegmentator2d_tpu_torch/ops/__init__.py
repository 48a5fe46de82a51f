"""Image operations: normalization, resampling, tiling weights, projection,
geometry and label metadata. ``ops.cuda`` holds the hand-written kernels."""

from .annotations import (combine_segmentations, get_annotation_labels,
                          get_label_mask, get_labels, set_annotation_meta)
from .gaussian import gaussian_map
from .geometry import (axis_name_to_index, orientation_code, reduce_dimensions,
                       reorient, restore_dimension)
from .normalize import (apply_scheme, auto_window, ct_normalize,
                        intensity_window, zscore_normalize)
from .projection import (extract_slice_index, flatten_vector_max, project,
                         project_array)
from .resample import resample, resample_uniform, resize_to_shape
from .visual import create_visual, label_to_rgb

__all__ = [
    'combine_segmentations', 'get_annotation_labels', 'get_label_mask',
    'get_labels', 'set_annotation_meta', 'gaussian_map', 'axis_name_to_index',
    'orientation_code', 'reduce_dimensions', 'reorient', 'restore_dimension',
    'apply_scheme', 'auto_window', 'ct_normalize', 'intensity_window',
    'zscore_normalize', 'extract_slice_index', 'flatten_vector_max', 'project',
    'project_array', 'resample', 'resample_uniform', 'resize_to_shape',
    'create_visual', 'label_to_rgb',
]

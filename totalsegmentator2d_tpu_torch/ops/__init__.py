"""Image operations: normalization, resampling, tiling weights, projection,
geometry and label metadata. ``ops.cuda`` holds the hand-written kernels."""

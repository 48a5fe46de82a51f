"""Host helpers: logging, files, dot-key params, packaged config, colors,
device selection."""

from . import colors, config, device, files, logging, params, temp, trace  # noqa: F401

"""Host helpers: logging, files, dot-key params, packaged config, colors,
device selection."""

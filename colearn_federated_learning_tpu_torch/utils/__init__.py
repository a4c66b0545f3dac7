"""Host-side helpers: registry, flat parameter layout, metrics,
checkpoints and device selection."""

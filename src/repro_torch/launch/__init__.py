"""Training entry points (port of ``repro.launch``)."""

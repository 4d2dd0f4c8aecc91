"""Readers of per-layer and end-to-end metrics. ``read(data, spec)`` takes
the run's data (``drivers``) and the metric's file; it returns None where
the run holds nothing to read."""

"""Headless analogs of the reference's ui/ layer: live capture, the
on-screen pattern and per-stage calibration visualization (no Qt: files
instead of windows, OpenCV rasters instead of matplotlib figures)."""

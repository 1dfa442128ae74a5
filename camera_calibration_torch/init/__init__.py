"""Calibration initialization of the port: relative pose, P3P, dense
initialization and the initial bundle-adjustment state."""

"""Calibration and fitting reports of the port, drawn without matplotlib."""

"""Stereo depth estimation on a calibrated two-camera rig."""

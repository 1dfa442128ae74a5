"""Joint bundle adjustment of the port."""

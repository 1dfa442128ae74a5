"""Dataset and state IO of the port."""

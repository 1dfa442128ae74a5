"""Camera models of the port (CentralGeneric in this slice)."""

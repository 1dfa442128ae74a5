"""Units of work, one module per kind, named by a traffic mix's ``unit``."""

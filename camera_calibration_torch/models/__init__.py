"""Camera models of the port: the grid models (CentralGeneric,
NoncentralGeneric), the parametric models (ThinPrismFisheye, OpenCV,
Radial) and a pinhole camera for synthetic ground truth."""

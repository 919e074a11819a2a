"""Image and dataset I/O of the port: PNG (native codec, else PIL), PFM,
ground truth, disparity colouring and point clouds."""

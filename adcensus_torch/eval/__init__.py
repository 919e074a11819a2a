"""Disparity evaluation metrics of the port (numpy, on the host)."""

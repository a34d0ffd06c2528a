"""Geometry: SE(3) on tensors and on the host, and the pinhole camera."""

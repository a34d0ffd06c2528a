"""Residuals, solvers, odometry, the map stores and their lifecycle, and the
carried depth calibration."""

"""Residuals, solvers, odometry and the carried depth calibration."""

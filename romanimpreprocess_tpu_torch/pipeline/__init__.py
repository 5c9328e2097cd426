"""Pipeline entry points (this slice: L1 -> L2 calibration)."""

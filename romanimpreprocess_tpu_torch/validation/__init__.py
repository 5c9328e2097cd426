"""Validation drivers (the reference's ``validation_tests`` layer)."""

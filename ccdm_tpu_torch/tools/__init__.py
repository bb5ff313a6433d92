"""Measurement scripts for the port on the card (run as files, not imported
by the package)."""

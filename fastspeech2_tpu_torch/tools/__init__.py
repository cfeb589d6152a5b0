"""Measurement scripts for the port; each runs on the card."""

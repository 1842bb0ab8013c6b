"""Utilities of the port: benchmark timing on the card."""

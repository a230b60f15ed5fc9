"""Conversion drivers."""

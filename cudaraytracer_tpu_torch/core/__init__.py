"""Subpackage: core."""

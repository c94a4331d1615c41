"""Subpackage: utils."""

"""Subpackage: models."""

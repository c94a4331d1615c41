"""Subpackage: apps."""

"""Subpackage: ops."""

"""Variant model."""

"""Genome-level utilities."""

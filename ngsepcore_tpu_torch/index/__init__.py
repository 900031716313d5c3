"""Minimizer seed index."""

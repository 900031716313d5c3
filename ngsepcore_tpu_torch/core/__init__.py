"""Sequence model and reference genome."""

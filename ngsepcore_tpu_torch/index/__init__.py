"""Seed and k-mer indexes."""

"""Variant calling: the fused align+call pipeline and its host stages."""

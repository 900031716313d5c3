"""Genome-wide association (per-site linear model)."""
from .glm import GeneralLinearModel

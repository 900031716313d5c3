"""Genotyping-by-sequencing: de-novo clustering and calling, coordinate
translation, UNEAK conversion."""
from .denovo import KmerPrefixReadsClusteringAlgorithm

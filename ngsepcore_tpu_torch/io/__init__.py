"""FASTA readers and writers."""

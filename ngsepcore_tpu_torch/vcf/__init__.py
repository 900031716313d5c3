"""VCF records and writer."""

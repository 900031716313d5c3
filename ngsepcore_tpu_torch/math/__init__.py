"""Log-space math, Phred scores and Fisher's exact test."""

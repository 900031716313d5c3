"""Short- and long-read alignment."""

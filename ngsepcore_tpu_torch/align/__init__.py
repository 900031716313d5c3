"""Short-read alignment."""

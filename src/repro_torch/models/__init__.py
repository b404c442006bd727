"""Models of the port (so far the paper's CNNs)."""

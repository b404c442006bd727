"""Model configurations of the port (so far the paper's CNNs)."""

"""Models of the port: the paper's CNNs, and the pure-SSM (mamba2-130m) and
hybrid (zamba2-1.2b) language models behind ``models.api``."""

"""Models of the port: the paper's CNNs and the pure-SSM language model
(mamba2-130m), behind ``models.api``."""

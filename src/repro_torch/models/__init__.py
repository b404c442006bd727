"""Models of the port: the paper's CNNs, and the pure-SSM (mamba2-130m),
hybrid (zamba2-1.2b) and dense or vlm (gemma2-2b and four more) language
models behind ``models.api``."""

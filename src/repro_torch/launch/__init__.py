"""Launch layer of the port: the serving driver (``serve.py``) and its step
functions (``steps.py``)."""

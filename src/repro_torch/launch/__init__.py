"""Launch layer of the port: the training driver (``train.py``), the serving
driver (``serve.py``), their step functions (``steps.py``) and the input
and parameter specs (``specs.py``)."""

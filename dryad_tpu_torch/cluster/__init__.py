"""The local cluster: a driver (``localjob.py``) and worker processes
(``worker.py``) running independent vertex tasks, over the
ProcessService control and data plane (``service.py``) and the
scheduler (``scheduler.py``)."""

"""Step builders of the LM stack: serving (``runtime/serve.py``), training
(``runtime/train.py``, ``runtime/loss.py``) and the step monitor
(``runtime/monitor.py``)."""

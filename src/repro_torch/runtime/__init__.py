"""Serving step builders for the LM stack (``runtime/serve.py``)."""

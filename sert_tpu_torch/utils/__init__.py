"""Utilities: typed configs (``config``), logging (``logging``), input and
numeric guards (``debug``) and tracing (``profiling``)."""

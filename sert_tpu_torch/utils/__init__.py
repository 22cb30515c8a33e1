"""Utilities: typed configs (``config``) and logging (``logging``)."""

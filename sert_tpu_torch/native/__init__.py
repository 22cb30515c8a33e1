"""Native (C++) host-side acceleration of prepare: the tokenizer, the
vocabulary counter and the window sweep, bound with ctypes
(``loader.maybe_load``), with a numpy fallback of identical output
(``data/windows.py``)."""

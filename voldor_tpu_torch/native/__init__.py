"""Native (C++) host components of the port, bound through ctypes
(``io.py``: the threaded .flo read-ahead)."""

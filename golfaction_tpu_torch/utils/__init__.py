"""Profiling and structured logging of the port (`profiling.py`, `logging.py`)."""

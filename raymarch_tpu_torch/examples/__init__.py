"""Runnable examples of the port: the five BASELINE configs (`configs.py`)."""

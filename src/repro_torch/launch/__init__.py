"""Serving entry points. Ported so far: the lockstep server (serve.py)."""

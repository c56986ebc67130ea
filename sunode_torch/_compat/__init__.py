"""Compatibility harnesses — NOT product surface.

Fallback engines used only when an optional third-party dependency is
absent: :mod:`pt_shim` provides a minimal PyTensor Op-protocol engine so
the PyTensor wrapper (and its tests) execute in environments without
pytensor.  When the real package is installed, everything in here is a
no-op and the real package wins.
"""

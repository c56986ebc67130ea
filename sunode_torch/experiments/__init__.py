"""Experiments of the port: measurements that are not part of the solver."""

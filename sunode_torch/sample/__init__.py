"""Sampling: batch-lockstep NUTS and its convergence diagnostics (the port
of ``sunode_tpu.sample``)."""

from sunode_torch.sample.diagnostics import ess_bulk, split_rhat
from sunode_torch.sample.nuts import NUTSResult, nuts_sample

__all__ = ["nuts_sample", "NUTSResult", "split_rhat", "ess_bulk"]

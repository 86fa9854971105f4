"""Point-to-point export entry (counterpart of
``omg_tools_tpu.export.export_p2p``)."""

from __future__ import annotations

import torch

from .export import Export

__all__ = ["ExportP2P"]


class ExportP2P(Export):

    def __init__(self, problem, options=None):
        Export.__init__(self, problem, options)

    def run(self, runner=None):
        """Export the embedded runtime.  ``runner`` may be a prebuilt
        float64 BatchedP2PRunner, on any device; otherwise one is built in
        float64 on the CPU."""
        if runner is None:
            from ..problems.batch import BatchedP2PRunner
            runner = BatchedP2PRunner(self.problem, dtype=torch.float64,
                                      device="cpu")
        return self.export(runner)

"""Deprecated location — absorbed into :mod:`repro_torch.dataflow.costmodel`.

The analytical FPGA cost models (paper §5.4, Tables 4/7, Fig 23) now live
in the dataflow DSE subsystem alongside the graph-level resource models
that build on them.  This module remains as an import-compatible shim:
every public name resolves to the ``repro_torch.dataflow.costmodel`` original
(lazily, so ``repro_torch.core`` and ``repro_torch.dataflow`` can import each other's
submodules without a cycle)."""
from __future__ import annotations


def __getattr__(name: str):
    from ..dataflow import costmodel as _cm
    try:
        return getattr(_cm, name)
    except AttributeError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None


def __dir__():
    from ..dataflow import costmodel as _cm
    return sorted(set(dir(_cm)))

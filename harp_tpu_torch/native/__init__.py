"""The port's native host components, built on demand and driven through
ctypes: the C++ text loader (``loader.cpp``, built by :mod:`.build` with
``g++``) and the streaming data sources over it (:mod:`.datasource`).
Where no ``g++`` exists the sources parse with numpy, with the same
semantics."""

from harp_tpu_torch.native.build import load_native, native_available
from harp_tpu_torch.native.datasource import (CSVPoints, CSVStream,
                                              FileSplits, load_csv)

__all__ = ["load_native", "native_available", "load_csv", "CSVStream",
           "CSVPoints", "FileSplits"]

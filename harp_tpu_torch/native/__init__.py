"""The port's native host components, built on demand and driven through
ctypes: the C++ text loader (``loader.cpp``, built by :mod:`.build` with
``g++``) and the data sources over it (:mod:`.datasource`).  Where no
``g++`` exists the sources parse in Python, with the same semantics."""

from harp_tpu_torch.native.build import load_native, native_available
from harp_tpu_torch.native.datasource import (CSVPoints, CSVStream,
                                              FileSplits, ParquetPoints,
                                              csr_to_ell, load_csv,
                                              load_csv_glob, load_libsvm,
                                              load_triples,
                                              load_triples_glob)

__all__ = ["load_native", "native_available", "load_csv", "load_csv_glob",
           "load_libsvm", "load_triples", "load_triples_glob", "csr_to_ell",
           "CSVStream", "CSVPoints", "ParquetPoints", "FileSplits"]

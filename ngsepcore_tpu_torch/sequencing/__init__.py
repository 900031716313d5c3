"""Reads processing: demultiplexing and trimming (host code)."""
from .demultiplex import ReadsDemultiplex, BarcodeMap
from .trimmer import RawReadsTrimmer

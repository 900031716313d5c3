from .assembler import Assembler
from .graph import AssemblyGraph, AssemblyEdge, AssemblyEmbedded

"""Gene models, protein translation and their file formats (host code)."""
from .model import Gene, Transcript, Transcriptome
from .gff3 import load_transcriptome_gff3
from .protein import ProteinTranslator

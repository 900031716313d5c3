"""Protein translation with the standard codon table.

Ref: src/ngsep/transcriptome/ProteinTranslator.java:29-83 (+ the bundled
ProteinTranslatorDefaultBundle.properties codon table).  A copy of
ngsepcore_tpu/transcriptome/protein.py.
"""
from __future__ import annotations


_CODON_TABLE = {}
_BASES = "TCAG"
_AMINO = (
    "FFLLSSSSYY**CC*W"  # TTT..TGG
    "LLLLPPPPHHQQRRRR"
    "IIIMTTTTNNKKSSRR"
    "VVVVAAAADDEEGGGG"
)
for _i, _b1 in enumerate(_BASES):
    for _j, _b2 in enumerate(_BASES):
        for _k, _b3 in enumerate(_BASES):
            _CODON_TABLE[_b1 + _b2 + _b3] = _AMINO[16 * _i + 4 * _j + _k]


class ProteinTranslator:
    START_CODON = "ATG"

    def translate_codon(self, codon: str) -> str:
        return _CODON_TABLE.get(codon.upper().replace("U", "T"), "X")

    def translate(self, dna: str, trim_at_stop: bool = True) -> str:
        out = []
        for i in range(0, len(dna) - 2, 3):
            aa = self.translate_codon(dna[i : i + 3])
            if aa == "*" and trim_at_stop:
                break
            out.append(aa)
        return "".join(out)

    def is_stop(self, codon: str) -> bool:
        return self.translate_codon(codon) == "*"

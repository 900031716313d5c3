from .sih import SingleIndividualHaplotyper, HaplotypeFragment, HaplotypeBlock

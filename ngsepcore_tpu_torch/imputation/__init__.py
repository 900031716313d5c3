from .genotype_imputer import GenotypeImputer

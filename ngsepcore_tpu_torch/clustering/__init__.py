from .trees import neighbor_joining, upgma, Dendrogram

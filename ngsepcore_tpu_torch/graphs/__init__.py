"""Graph algorithms of the SV clustering (host numpy)."""
from .components import maximal_cliques, strongly_connected_components
